"""The whole slice: ``SparsePCA`` of the torch port against the JAX package.

On the Gram engine: explained variances to 1e-5 relative; components and
scores to 1e-4 x max|.| (both packages apply the same sign convention).
On the densified and tiled engines with the Lanczos solvers (``SparsePCABuilder``'s
default method, and ``lanczos_block``): each package draws its own start
vector, so the converged explained variances are held to 1e-4 relative to
the largest and the scores to 1e-3 x max|.|.
"""

import os
import re
import subprocess
import sys
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
    MaskedSparsePCABuilder, SparseMatrix, SparsePCA, SparsePCABuilder,
)
from single_algebra_tpu_torch.models import StreamingSparsePCA, tsne
from single_algebra_tpu_torch.parallel import (
    ShardedDensified, make_mesh, sharded_gram_pca, sharded_pca_fit_transform,
)
from single_algebra_tpu_torch.similarity import CosineSimilarity
from single_algebra_tpu_torch.linalg import gram as tgram
from single_algebra_tpu_torch.models import pca as tpca
from single_algebra_tpu_torch.types import PowerIterationNormalizer as PIN
from single_algebra_tpu_torch.types import SVDMethod

from tests.conftest import cluster_counts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fit_both(X, k=6, random=True, center=True):
    """Fitted (port model, port scores, JAX model, JAX scores)."""

    tm = SVDMethod.random(10, 7, PIN.QR) if random else SVDMethod.lanczos()
    jm = JSVD.random(10, 7, JPIN.QR) if random else JSVD.lanczos()
    tp = (SparsePCABuilder().n_components(k).svd_method(tm).center(center)
          .engine("gram").build())
    jp = (jmodels.SparsePCABuilder().n_components(k).svd_method(jm).center(center)
          .engine("gram").build())
    T = tp.fit_transform(SparseMatrix.from_scipy(X, device="cpu")).numpy()
    Tj = np.asarray(jp.fit_transform(JMatrix.from_scipy(X)))
    return tp, T, jp, Tj


def assert_models_match(tp, T, jp, Tj, ev_rtol=1e-5):
    evj = np.asarray(jp.explained_variance_)
    np.testing.assert_allclose(tp.explained_variance_, evj, rtol=ev_rtol)
    Cj = np.asarray(jp.components_)
    assert np.abs(tp.components_.numpy() - Cj).max() <= 1e-4 * np.abs(Cj).max()
    if T is not None:
        assert np.abs(T - Tj).max() <= 1e-4 * np.abs(Tj).max()
    np.testing.assert_allclose(tp.mean_, np.asarray(jp.mean_), rtol=1e-6)
    assert tp.total_variance_ == pytest.approx(jp.total_variance_, rel=1e-6)
    assert tp.noise_variance_ == pytest.approx(jp.noise_variance_, rel=1e-4)


@pytest.fixture(scope="module")
def counts():
    return cluster_counts(600, 140, n_clusters=8, seed=3).astype(np.float32)


@pytest.fixture(scope="module")
def fitted(counts):
    return fit_both(counts)


def test_slice_matches_jax(fitted):
    tp, T, jp, Tj = fitted
    assert T.shape == (600, 6) and np.isfinite(T).all()
    assert_models_match(tp, T, jp, Tj)


def test_slice_matches_exact_pca(fitted, counts):
    tp = fitted[0]
    Xc = counts.toarray().astype(np.float64)
    Xc -= Xc.mean(axis=0)
    ev = np.linalg.svd(Xc, compute_uv=False)[:6] ** 2 / (Xc.shape[0] - 1)
    np.testing.assert_allclose(tp.explained_variance_, ev, rtol=1e-5)


def test_lanczos_maps_to_uncentered_gram(counts):
    tp, T, jp, Tj = fit_both(counts, k=5, random=False)
    assert_models_match(tp, T, jp, Tj)
    s = np.linalg.svd(counts.toarray().astype(np.float64), compute_uv=False)[:5]
    np.testing.assert_allclose(tp.explained_variance_, s**2 / 599, rtol=1e-5)


def test_uncentered_randomized(counts):
    assert_models_match(*fit_both(counts, k=4, center=False))


def test_wide_blocked_gram_and_large_solve():
    # pp > 4096: blocked Gram pass and the randomized large-Gram solve; each
    # package draws its own sketch, so the planted top spectrum must come
    # out the same from both to 1e-5
    X = cluster_counts(1500, 4500, n_clusters=6, seed=5).astype(np.float32)
    assert_models_match(*fit_both(X, k=4))


def test_transform_and_inverse(fitted, counts):
    tp, T, jp, _ = fitted
    m = SparseMatrix.from_scipy(counts, device="cpu")
    T2 = tp.transform(m).numpy()  # a fresh matrix: builds its own engine
    assert np.abs(T2 - T).max() <= 1e-5 * np.abs(T).max()
    R = tp.inverse_transform(torch.from_numpy(T)).numpy()
    Rj = np.asarray(jp.inverse_transform(np.asarray(T)))
    assert np.abs(R - Rj).max() <= 1e-4 * np.abs(Rj).max()
    np.testing.assert_allclose(tp.explained_variance_ratio().numpy(),
                               np.asarray(jp.explained_variance_ratio()), rtol=1e-5)
    assert float(tp.cumulative_explained_variance_ratio()[-1]) == pytest.approx(1.0)
    Fj = np.asarray(jp.feature_importances())
    assert np.abs(tp.feature_importances().numpy() - Fj).max() <= 1e-4 * Fj.max()


def test_save_load_across_packages(fitted, counts, tmp_path):
    tp, T, jp, _ = fitted
    jp.save(str(tmp_path / "jax_model"))
    loaded = SparsePCA.load(str(tmp_path / "jax_model"), device="cpu")  # .npz suffix added
    assert loaded.n_components == 6 and loaded.center
    np.testing.assert_array_equal(loaded.components_.numpy(), np.asarray(jp.components_))
    np.testing.assert_array_equal(loaded.explained_variance_, np.asarray(jp.explained_variance_))
    np.testing.assert_array_equal(loaded.mean_, np.asarray(jp.mean_))
    assert loaded.total_variance_ == jp.total_variance_
    loaded.engine = "gram"  # the JAX model was fitted on the Gram engine; project on it too
    T2 = loaded.transform(counts).numpy()
    assert np.abs(T2 - np.asarray(jp.transform(JMatrix.from_scipy(counts)))).max() <= 1e-4 * np.abs(T2).max()

    tp.save(str(tmp_path / "torch_model.npz"))
    jl = jmodels.SparsePCA.load(str(tmp_path / "torch_model.npz"))
    np.testing.assert_array_equal(np.asarray(jl.components_), tp.components_.numpy())
    np.testing.assert_array_equal(np.asarray(jl.explained_variance_), tp.explained_variance_)
    assert jl.noise_variance_ == pytest.approx(tp.noise_variance_)


def test_from_state(fitted, counts):
    _, T, jp, Tj = fitted
    state = dict(components=np.asarray(jp.components_),
                 explained_variance=np.asarray(jp.explained_variance_),
                 mean=np.asarray(jp.mean_), total_variance=jp.total_variance_,
                 noise_variance=jp.noise_variance_)
    model = SparsePCA.from_state(state, device="cpu")
    assert model.n_components == 6
    model.engine = "gram"
    T2 = model.transform(SparseMatrix.from_scipy(counts, device="cpu")).numpy()
    assert np.abs(T2 - Tj).max() <= 1e-4 * np.abs(Tj).max()


def test_engine_selection(counts):
    m = SparseMatrix.from_scipy(counts, device="cpu")
    # on a CPU device 'auto' is 'sparse' (the gather engine), as off the TPU
    # in the JAX package
    sparse = tpca.make_engine_operator(m, "auto")
    assert isinstance(sparse, tpca.SparseOperator)
    assert tpca.make_engine_operator(m, "sparse") is sparse
    dense = tpca.make_engine_operator(m, "dense")
    assert isinstance(dense, tpca.DensifiedOperator) and dense.lo is None
    assert tpca.make_engine_operator(m, "dense") is dense
    with pytest.raises(ValueError):
        tpca.make_engine_operator(m, "bogus")
    op = tpca.make_engine_operator(m, "gram")
    assert isinstance(op, tgram.GramPCAEngine)
    assert tpca.make_engine_operator(m, "gram") is op
    tiled = tpca.make_engine_operator(m, "tiled")
    assert isinstance(tiled, tpca.TiledSparseOperator)
    assert tpca.make_engine_operator(m, "tiled") is tiled


@pytest.mark.parametrize("engine", ["auto", "sparse"])
def test_cpu_default_engine_fits_and_matches_jax(counts, engine):
    """``SparsePCA().fit`` of a CPU matrix, 'auto' and 'sparse': the gather
    engine with the builder's default (Lanczos), against the JAX package's
    model (its own start vector: EVs to 1e-4 of the largest)."""

    tp = SparsePCA(n_components=4, engine=engine)
    tp.fit(SparseMatrix.from_scipy(counts, device="cpu"))
    jp = jmodels.SparsePCA(n_components=4, engine=engine)
    jp.fit(JMatrix.from_scipy(counts))
    evj = np.asarray(jp.explained_variance_, np.float64)
    assert np.abs(tp.explained_variance_ - evj).max() <= 1e-4 * evj[0]
    assert tp.lanczos_steps_taken_ > 0


def _jax_engine_names():
    """The engine names the JAX package's ``make_engine_operator`` takes."""

    import inspect

    from single_algebra_tpu.models import pca as jpca

    src = inspect.getsource(jpca.make_engine_operator)
    return sorted(set(re.findall(r'engine == "(\w+)"', src)))


@pytest.mark.parametrize("engine", _jax_engine_names())
def test_port_accepts_every_jax_engine_name(counts, engine):
    """Every engine name of the JAX package builds an engine in the port
    (none is left unported)."""

    m = SparseMatrix.from_scipy(counts, device="cpu")
    op = tpca.make_engine_operator(m, engine)
    assert op is tpca.make_engine_operator(m, engine)
    B = torch.ones((counts.shape[1], 1))
    want = counts.toarray().astype(np.float64) @ np.ones((counts.shape[1], 1))
    assert np.abs(getattr(op, "mv_precise", op.mv)(B).numpy() - want).max() <= 1e-5 * want.max()


@pytest.mark.parametrize(
    "dense_budget, gram_budget, want",
    [(1e9, 1e9, "dense"), (1e4, 1e9, "gram"), (1e4, 1e4, "tiled"), (4e3, 1e4, "sparse")],
)
def test_auto_decision_order_on_cuda(monkeypatch, counts, dense_budget, gram_budget, want):
    """'auto' on a CUDA device: dense when the bf16 form fits its budget,
    else gram when its plan fits, else tiled when its payload (patched to
    5,000 bytes, its rmv forms to none) fits the dense budget, else sparse
    (budgets patched, so the order is checked without a card)."""

    m = SparseMatrix.from_scipy(counts, device="cuda")
    monkeypatch.setattr(tpca.DensifiedOperator, "hbm_budget_bytes",
                        staticmethod(lambda device: int(dense_budget)))
    monkeypatch.setattr(tgram.GramPCAEngine, "hbm_budget_bytes",
                        staticmethod(lambda device: int(gram_budget)))
    monkeypatch.setattr(tpca.TiledSparseOperator, "payload_bytes",
                        classmethod(lambda cls, mm: 5000))
    monkeypatch.setattr(tpca.TiledSparseOperator, "form_bytes", classmethod(lambda cls, mm: 0))
    built = []
    for cls, name in ((tpca.DensifiedOperator, "dense"), (tgram.GramPCAEngine, "gram"),
                      (tpca.TiledSparseOperator, "tiled"), (tpca.SparseOperator, "sparse")):
        monkeypatch.setattr(cls, "from_matrix", classmethod(
            lambda cls, mm, name=name: built.append((name, mm)) or f"{name}-engine"))
    assert tpca.make_engine_operator(m, "auto") == f"{want}-engine"
    assert built == [(want, m)]


class _ProjectionProbe:
    """An operator whose precise product differs from its plain one, to
    show which one a projection takes."""

    def __init__(self, a):
        self.a, self.calls = a, []

    shape = property(lambda self: tuple(self.a.shape))
    dtype = property(lambda self: self.a.dtype)
    device = property(lambda self: self.a.device)

    def mv(self, B):
        self.calls.append("mv")
        return self.a @ B + 1.0

    def mv_precise(self, B):
        self.calls.append("mv_precise")
        return self.a @ B


def test_transform_projects_with_mv_precise(fitted, counts):
    tp, T, _, _ = fitted
    m = SparseMatrix.from_scipy(counts, device="cpu")
    probe = _ProjectionProbe(torch.from_numpy(counts.toarray()))
    m._operator_cache["gram"] = probe
    tp.engine = "gram"
    T2 = tp.transform(m).numpy()
    assert probe.calls == ["mv_precise"]
    assert np.abs(T2 - T).max() <= 1e-4 * np.abs(T).max()


def fit_lanczos_both(X, engine, k=5, block=None, steps=None, center=True):
    """(port model, port scores, JAX model, JAX scores) with the Lanczos
    method on ``engine``; each package draws its own start vector."""

    tp = (SparsePCABuilder().n_components(k).center(center).engine(engine)
          .lanczos_block(block).build())
    jp = (jmodels.SparsePCABuilder().n_components(k).center(center).engine(engine)
          .lanczos_block(block).build())
    tp.lanczos_steps = jp.lanczos_steps = steps
    T = tp.fit_transform(SparseMatrix.from_scipy(X, device="cpu")).numpy()
    Tj = np.asarray(jp.fit_transform(JMatrix.from_scipy(X)))
    return tp, T, jp, Tj


def assert_lanczos_models_match(tp, T, jp, Tj, counts, k):
    evj = np.asarray(jp.explained_variance_, np.float64)
    assert np.abs(tp.explained_variance_ - evj).max() <= 1e-4 * evj[0]
    # Lanczos never centers the SVD: the uncentered singular values
    s = np.linalg.svd(counts.toarray().astype(np.float64), compute_uv=False)[:k]
    assert np.abs(tp.explained_variance_ - s**2 / (counts.shape[0] - 1)).max() <= 1e-4 * evj[0]
    assert T.shape == Tj.shape and np.isfinite(T).all()
    assert np.abs(T - Tj).max() <= 1e-3 * np.abs(Tj).max()
    np.testing.assert_allclose(tp.mean_, np.asarray(jp.mean_), rtol=1e-6)
    assert tp.total_variance_ == pytest.approx(jp.total_variance_, rel=1e-6)


def test_lanczos_and_block_lanczos_on_tiled_match_jax(counts):
    """The Lanczos method on the tiled engine, scalar and block: it runs
    and gives the JAX package's model."""

    for block in (None, 4):
        tp, T, jp, Tj = fit_lanczos_both(counts, "tiled", k=3, block=block)
        assert tp.lanczos_steps_taken_ > 0
        assert_lanczos_models_match(tp, T, jp, Tj, counts, 3)


@pytest.mark.parametrize("engine", ["dense", "tiled"])
@pytest.mark.parametrize("block", [None, 8])
def test_default_builder_lanczos_matches_jax(counts, engine, block):
    """``SparsePCABuilder``'s defaults (Lanczos, adaptive at tolerance 1e-6), and
    ``lanczos_block(8)``, on the densified and the tiled engine."""

    tp, T, jp, Tj = fit_lanczos_both(counts, engine, k=5, block=block)
    assert_lanczos_models_match(tp, T, jp, Tj, counts, 5)
    budget = 384 if block is None else 384 // block
    assert 0 < tp.lanczos_steps_taken_ < budget  # it stopped on convergence


@pytest.mark.parametrize("engine", ["dense", "tiled"])
@pytest.mark.parametrize("block", [None, 4])
def test_fit_graph_lanczos_matches_jax_from_its_start(counts, engine, block):
    """``_fit_graph``'s Lanczos branches from the JAX package's own start
    vector / block: the two recurrences then agree step for step, so the
    singular values are held to 1e-5 and components and scores to 1e-4."""

    import jax
    import jax.numpy as jnp

    from single_algebra_tpu.models import pca as jpca

    k, seed = 4, 42
    p = counts.shape[1]
    op = tpca.make_engine_operator(SparseMatrix.from_scipy(counts, device="cpu"), engine)
    jop = jpca.make_engine_operator(JMatrix.from_scipy(counts), engine)
    mean = np.asarray(counts.mean(axis=0)).ravel().astype(np.float32)
    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    if block is None:
        start = np.array(jax.random.normal(key, (p,), dtype=jnp.float32))
    else:
        start = np.array(jnp.linalg.qr(jax.random.normal(key, (p, block), dtype=jnp.float32))[0])
    js, jvt, jT = jpca._fit_graph(
        jop, jnp.asarray(mean), seed, k=k, method=JSVD.lanczos(), center=True, steps=None,
        want_transform=True, tol=1e-6, lanczos_block=block)
    info = {}
    s, vt, T = tpca._fit_graph(
        op, torch.from_numpy(mean), seed, k=k, method=SVDMethod.lanczos(), center=True,
        steps=None, want_transform=True, tol=1e-6, lanczos_block=block,
        start=torch.from_numpy(start), info=info)
    assert info["steps"] > 0
    np.testing.assert_allclose(s.numpy() ** 2, np.asarray(js) ** 2, rtol=1e-5)
    jvt, jT = np.asarray(jvt), np.asarray(jT)
    assert np.abs(vt.numpy() - jvt).max() <= 1e-4 * np.abs(jvt).max()
    assert np.abs(T.numpy() - jT).max() <= 1e-4 * np.abs(jT).max()


@pytest.mark.parametrize("engine", ["dense", "tiled"])
def test_lanczos_steps_is_the_krylov_dimension(counts, engine):
    """A tuned ``lanczos_steps`` is the Krylov budget of the scalar solver
    and is converted to block steps for the block solver."""

    m = SparseMatrix.from_scipy(counts, device="cpu")
    pca = (SparsePCABuilder().n_components(4).engine(engine).tolerance(0.0)
           .lanczos_steps(48).build())
    pca.fit(m)
    assert pca.lanczos_steps_taken_ == 48
    pca = (SparsePCABuilder().n_components(4).engine(engine).tolerance(0.0)
           .lanczos_steps(48).lanczos_block(8).build())
    pca.fit(m)
    assert pca.lanczos_steps_taken_ == 6


def test_dense_engine_inexact_values_keep_lo(counts):
    """Non-bf16-exact values: the densified engine keeps its lo half and
    the Lanczos fit still agrees with the JAX package and the exact SVD."""

    X = sp.csr_matrix((counts.data * np.float32(1.2345), counts.indices, counts.indptr),
                      shape=counts.shape)
    tp, T, jp, Tj = fit_lanczos_both(X, "dense", k=4)
    assert_lanczos_models_match(tp, T, jp, Tj, X, 4)


def test_dense_engine_randomized_matches_jax(counts):
    """The randomized method on the densified engine, both packages on
    their own sketch: converged explained variances to 1e-4."""

    tm, jm = SVDMethod.random(10, 7, PIN.QR), JSVD.random(10, 7, JPIN.QR)
    tp = SparsePCABuilder().n_components(5).svd_method(tm).engine("dense").build()
    jp = jmodels.SparsePCABuilder().n_components(5).svd_method(jm).engine("dense").build()
    T = tp.fit_transform(SparseMatrix.from_scipy(counts, device="cpu")).numpy()
    Tj = np.asarray(jp.fit_transform(JMatrix.from_scipy(counts)))
    evj = np.asarray(jp.explained_variance_, np.float64)
    assert np.abs(tp.explained_variance_ - evj).max() <= 1e-4 * evj[0]
    assert np.abs(T - Tj).max() <= 1e-3 * np.abs(Tj).max()


def test_budgets_follow_device_memory(monkeypatch):
    """0.6 / 0.8 of the card's memory; on an 80 GB card the 1M x 30k dense
    bf16 form (60 GB) is over the densified engine's 48 GB budget."""

    from single_algebra_tpu_torch.linalg import operators

    fake = lambda device: 80_000_000_000 if torch.device(device).type == "cuda" else None
    monkeypatch.setattr(operators, "hbm_bytes", fake)
    monkeypatch.setattr(tgram, "hbm_bytes", fake)
    assert operators.DensifiedOperator.hbm_budget_bytes("cuda") == 48_000_000_000
    assert tgram.GramPCAEngine.hbm_budget_bytes("cuda") == 64_000_000_000
    assert not operators.DensifiedOperator.fits((1_000_000, 30_000), device="cuda")
    assert operators.DensifiedOperator.fits((400_000, 30_000), device="cuda")
    assert operators.DensifiedOperator.hbm_budget_bytes("cpu") == 9 << 30


def test_lanczos_knobs_warn(counts):
    pca = (SparsePCABuilder().n_components(3).svd_method(SVDMethod.lanczos())
           .lanczos_steps(32).engine("gram").build())
    with pytest.warns(UserWarning, match="lanczos_steps"):
        pca.fit(SparseMatrix.from_scipy(counts, device="cpu"))


def test_default_device_is_the_card(counts):
    assert SparseMatrix.from_scipy(counts).device.type == "cuda"
    assert SparseMatrix.from_scipy(counts, device="cpu").device.type == "cpu"
    assert tpca._as_matrix(counts).device.type == "cuda"


def test_default_fit_runs_on_the_card_or_raises(counts, monkeypatch):
    """A scipy input goes to the card; without one the fit raises instead
    of running on the CPU. On a card this small matrix's dense form fits,
    so 'auto' takes the densified engine; with the dense budget at 0 it
    takes the Gram engine there (the card run of this check is
    ``tests/test_torch_card.py``, which imports no JAX)."""

    pca = (SparsePCABuilder().n_components(3)
           .svd_method(SVDMethod.random(10, 7, PIN.QR)).build())
    if torch.cuda.is_available():
        assert pca.fit_transform(counts).device.type == "cuda"
        monkeypatch.setattr(tpca.DensifiedOperator, "hbm_budget_bytes",
                            staticmethod(lambda device: 0))
        assert pca.fit_transform(counts).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            pca.fit_transform(counts)


@pytest.mark.parametrize("engine", ["gram", "tiled", "dense"])
def test_cpu_device_runs_both_engines(counts, engine):
    m = SparseMatrix.from_scipy(counts, device="cpu")
    T = (SparsePCABuilder().n_components(3).engine(engine)
         .svd_method(SVDMethod.random(10, 7, PIN.QR)).build().fit_transform(m))
    assert T.device.type == "cpu" and T.shape == (600, 3)
    assert m._operator_cache[engine].device.type == "cpu"


def test_port_imports_no_jax():
    code = (
        "import sys, numpy as np, scipy.sparse as sp\n"
        "import single_algebra_tpu_torch as t\n"
        "X = sp.random(300, 40, density=0.2, format='csr', random_state=0)\n"
        "m = t.SparseMatrix.from_scipy(X, device='cpu')\n"
        "T = t.SparsePCABuilder().n_components(3).engine('gram').build().fit_transform(m)\n"
        "assert T.shape == (300, 3)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'single_algebra_tpu')\n"
        "             or k.startswith(('jax.', 'single_algebra_tpu.')))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("random", [True, False], ids=["randomized", "lanczos"])
def test_dense_engine_float64_centered_matches_jax(counts, random):
    """A float64 matrix on the densified (float32) engine, centered: the
    float64 mean promotes the centered products as ``jnp`` does, through
    ``fit``, ``fit_transform`` and ``transform``, with the JAX package's
    dtypes (the randomized solve then runs in float64; Lanczos solves the
    raw float32 engine and projects in float64)."""

    X = counts.astype(np.float64)
    tm = SVDMethod.random(10, 7, PIN.QR) if random else SVDMethod.lanczos()
    jm = JSVD.random(10, 7, JPIN.QR) if random else JSVD.lanczos()
    tp = SparsePCABuilder().n_components(4).svd_method(tm).engine("dense").build()
    jp = jmodels.SparsePCABuilder().n_components(4).svd_method(jm).engine("dense").build()
    m, jm_ = SparseMatrix.from_scipy(X, device="cpu"), JMatrix.from_scipy(X)
    T = tp.fit_transform(m).numpy()
    Tj = np.asarray(jp.fit_transform(jm_))
    assert T.dtype == Tj.dtype == np.float64
    assert tp.components_.numpy().dtype == np.asarray(jp.components_).dtype
    assert tp.explained_variance_.dtype == np.asarray(jp.explained_variance_).dtype
    evj = np.asarray(jp.explained_variance_, np.float64)
    assert np.abs(tp.explained_variance_ - evj).max() <= 1e-4 * evj[0]
    assert np.abs(T - Tj).max() <= 1e-3 * np.abs(Tj).max()
    T2, T2j = tp.transform(m).numpy(), np.asarray(jp.transform(jm_))
    assert T2.dtype == T2j.dtype == np.float64
    assert np.abs(T2 - T2j).max() <= 1e-3 * np.abs(T2j).max()
    np.testing.assert_allclose(T2, T, rtol=0, atol=1e-9 * np.abs(T).max())
    tq = SparsePCABuilder().n_components(4).svd_method(tm).engine("dense").build()
    tq.fit(m)
    np.testing.assert_allclose(tq.explained_variance_, tp.explained_variance_, rtol=1e-12)


@pytest.mark.parametrize("engine", ["dense", "tiled", "sparse"])
@pytest.mark.parametrize("block", [None, 4])
def test_more_components_than_min_dim_match_jax_gram(engine, block):
    """k = 30 > min(60, 25): every Lanczos solver returns k explained
    variances (the surplus 0) and ``components_`` of shape (k, p), as the
    JAX Gram engine does."""

    X = cluster_counts(60, 25, n_clusters=4, seed=3).astype(np.float32)
    tp = SparsePCABuilder().n_components(30).engine(engine).lanczos_block(block).build()
    T = tp.fit_transform(SparseMatrix.from_scipy(X, device="cpu")).numpy()
    with warnings.catch_warnings():  # the Gram engine ignores lanczos_block, and says so
        warnings.simplefilter("ignore", UserWarning)
        jp = (jmodels.SparsePCABuilder().n_components(30).engine("gram")
              .lanczos_block(block).build())
        Tj = np.asarray(jp.fit_transform(JMatrix.from_scipy(X)))
    ev, evj = tp.explained_variance_, np.asarray(jp.explained_variance_)
    assert ev.shape == evj.shape == (30,)
    assert np.abs(ev - evj).max() <= 1e-4 * evj[0]
    assert (ev[25:] <= 1e-6 * ev[0]).all()  # the surplus is 0 up to roundoff
    C, Cj = tp.components_.numpy(), np.asarray(jp.components_)
    assert C.shape == Cj.shape == (30, 25) and T.shape == Tj.shape == (60, 30)
    assert np.isfinite(C).all() and np.isfinite(T).all()
    assert np.abs(C[:5] - Cj[:5]).max() <= 1e-3
    assert np.abs(T[:, :5] - Tj[:, :5]).max() <= 1e-3 * np.abs(Tj).max()


def test_tsne_and_streaming_import_no_jax_ml_dtypes_or_sklearn():
    code = (
        "import sys, numpy as np, scipy.sparse as sp\n"
        "from single_algebra_tpu_torch.models import tsne, streaming_pca\n"
        "x = np.random.default_rng(0).standard_normal((40, 5))\n"
        "cfg = tsne.TSNEConfig(perplexity=5.0, epochs=3)\n"
        "assert tsne.run(x, cfg, device='cpu').shape == (40, 2)\n"
        "cfg = tsne.TSNEConfig(perplexity=5.0, epochs=3, mode='knn')\n"
        "assert tsne.run(x, cfg, device='cpu').shape == (40, 2)\n"
        "X = sp.random(300, 40, density=0.2, format='csr', random_state=0)\n"
        "p = streaming_pca.StreamingSparsePCA(3, 40, device='cpu').partial_fit(X).finalize()\n"
        "assert p.transform(X).shape == (300, 3)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'single_algebra_tpu', 'ml_dtypes', 'sklearn'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _cpu(X):
    return SparseMatrix.from_scipy(X, device="cpu")


ENTRY_POINTS = {
    "SparsePCA.fit": lambda X: SparsePCABuilder().n_components(3).engine("gram").svd_method(
        SVDMethod.random(10, 7, PIN.QR)).build().fit(_cpu(X)),
    "SparsePCA.fit_transform": lambda X: SparsePCABuilder().n_components(3).engine(
        "dense").build().fit_transform(_cpu(X)),
    "SparseMatrix.matmul_dense": lambda X: _cpu(X) @ torch.ones((X.shape[1], 2)),
    "MaskedSparsePCA.fit": lambda X: MaskedSparsePCABuilder().mask(
        np.arange(X.shape[1]) % 2 == 0).n_components(2).engine("sparse").build().fit(_cpu(X)),
    "CosineSimilarity.pairwise": lambda X: CosineSimilarity(device="cpu").pairwise(
        torch.from_numpy(X[:20].toarray())),
    "StreamingSparsePCA": lambda X: StreamingSparsePCA(
        3, X.shape[1], device="cpu").partial_fit(X).finalize(),
    "tsne.run": lambda X: tsne.run(X[:100].toarray(), tsne.TSNEConfig(
        perplexity=5.0, epochs=2), device="cpu"),
    "tsne.run(mesh=)": lambda X: tsne.run(X[:100].toarray(), tsne.TSNEConfig(
        perplexity=5.0, epochs=2), mesh=make_mesh(3, device="cpu")),
    "StreamingSparsePCA(mesh=)": lambda X: StreamingSparsePCA(
        3, X.shape[1], mesh=make_mesh(2, device="cpu")).partial_fit(X).finalize(),
    "sharded_pca_fit_transform": lambda X: sharded_pca_fit_transform(
        _cpu(X), 3, mesh=make_mesh(2, device="cpu"), engine="tiled"),
    "sharded_gram_pca": lambda X: sharded_gram_pca(_cpu(X), make_mesh(2, device="cpu"), 3),
    "ShardedDensified.rmv": lambda X: ShardedDensified.from_matrix(
        _cpu(X), make_mesh(2, device="cpu")).rmv(torch.ones((X.shape[0], 2))),
}


@pytest.fixture
def callers_flags():
    """TF32 on, "high" float32 precision and bf16 reduced-precision
    reduction on, as a caller may set them after importing the port; the
    process's own flags come back afterwards."""

    mm = torch.backends.cuda.matmul
    saved = (torch.get_float32_matmul_precision(), mm.allow_tf32,
             mm.allow_bf16_reduced_precision_reduction, torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("high")
    mm.allow_tf32 = True
    mm.allow_bf16_reduced_precision_reduction = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield ("high", True, True, True)
    finally:
        torch.set_float32_matmul_precision(saved[0])
        mm.allow_tf32 = saved[1]
        mm.allow_bf16_reduced_precision_reduction = saved[2]
        torch.backends.cudnn.allow_tf32 = saved[3]


def _flags():
    mm = torch.backends.cuda.matmul
    return (torch.get_float32_matmul_precision(), mm.allow_tf32,
            mm.allow_bf16_reduced_precision_reduction, torch.backends.cudnn.allow_tf32)


class _ProductSpy(torch.overrides.TorchFunctionMode):
    """Records the precision flags at every matrix product torch runs."""

    PRODUCTS = {"mm", "matmul", "addmm", "addmm_", "bmm", "baddbmm", "mv",
                "__matmul__", "__rmatmul__", "_int_mm", "einsum"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", "") in self.PRODUCTS:
            self.seen.append(_flags())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_precision_policy_holds_inside_each_entry_point(counts, callers_flags, entry):
    """Flags the caller flips after import do not reach the port's
    products: every matrix product inside a public entry point sees full
    float32, and the caller's flags are back after it returns."""

    spy = _ProductSpy()
    with spy:
        ENTRY_POINTS[entry](counts)
    assert spy.seen, "the entry point made no matrix product"
    assert set(spy.seen) == {("highest", False, False, False)}
    assert _flags() == callers_flags
