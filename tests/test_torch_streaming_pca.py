"""``StreamingSparsePCA`` of the torch port against the JAX package.

Both stream the same CSR chunks (the JAX densify kernel in interpret
mode, the port's plain densify on the CPU). Tolerances: the accumulated
Gram and column moments within 1e-6 of their largest entry, explained
variances within 1e-6 of the largest, components within 1e-5 up to sign,
scores within 1e-5 of the largest. The data have gapped spectra (planted
clusters), so components are well defined to that level.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
from single_algebra_tpu.models import StreamingSparsePCA as JStreaming
from single_algebra_tpu_torch import SparseMatrix
from single_algebra_tpu_torch.models import StreamingSparsePCA
from single_algebra_tpu_torch.linalg.gram import EIGH_MAX_PP
from single_algebra_tpu_torch.models import streaming_pca as smod

from tests.conftest import cluster_counts


def matrix(n=700, p=120, counts=True, seed=0):
    """Planted-cluster counts, or their log1p (not bf16-exact: the
    float32 tier)."""

    X = cluster_counts(n, p, n_clusters=6, seed=seed, density=0.15).astype(np.float32)
    if not counts:
        X.data = np.log1p(X.data) * np.float32(1.37)
    return X


def stream(cls, X, chunk_rows, **kw):
    pca = cls(**kw)
    for r0 in range(0, X.shape[0], chunk_rows):
        pca.partial_fit(X[r0:r0 + chunk_rows])
    return pca.finalize()


def assert_close_of_max(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


def assert_fits_match(tp, jp):
    ev, evj = tp.explained_variance_, np.asarray(jp.explained_variance_)
    assert ev.dtype == np.float32
    assert_close_of_max(ev, evj, 1e-6)
    C, Cj = tp.components_.numpy(), np.asarray(jp.components_)
    signs = np.sign((C * Cj).sum(1))[:, None]
    assert_close_of_max(C * signs, Cj, 1e-5)
    np.testing.assert_allclose(tp.mean_.numpy(), np.asarray(jp.mean_), rtol=1e-6, atol=1e-7)
    assert tp.total_variance_ == pytest.approx(jp.total_variance_, rel=1e-6)
    return signs


@pytest.mark.parametrize("chunk_rows", [97, 256, 700])
@pytest.mark.parametrize("counts", [True, False])
def test_streaming_matches_jax(chunk_rows, counts):
    X = matrix(counts=counts)
    kw = dict(n_components=5, n_features=X.shape[1], random_seed=1)
    tp = stream(StreamingSparsePCA, X, chunk_rows, device="cpu", **kw)
    jp = stream(JStreaming, X, chunk_rows, **kw)
    assert tp._n == jp._n == X.shape[0]
    assert_close_of_max(tp._G.numpy(), np.asarray(jp._G), 1e-6)
    assert_close_of_max(tp.col_sums(), jp.col_sums(), 1e-6)
    assert_close_of_max(tp.col_sums_squared(), jp.col_sums_squared(), 1e-6)
    assert_close_of_max(tp.col_var(), jp.col_var(), 1e-6)
    signs = assert_fits_match(tp, jp)
    T, Tj = tp.transform(X), jp.transform(X)
    assert isinstance(T, np.ndarray) and T.shape == (X.shape[0], 5)
    assert_close_of_max(T * signs.T, Tj, 1e-5)


def test_streaming_matches_exact_pca():
    X = matrix(counts=True, seed=2)
    tp = stream(StreamingSparsePCA, X, 256, n_components=4, n_features=X.shape[1],
                device="cpu")
    D = X.toarray().astype(np.float64)
    Dc = D - D.mean(axis=0)
    ev_ref = np.linalg.svd(Dc, compute_uv=False)[:4] ** 2 / (X.shape[0] - 1)
    assert_close_of_max(tp.explained_variance_, ev_ref, 1e-5)
    np.testing.assert_allclose(tp.col_var(), Dc.var(axis=0, ddof=1), rtol=1e-6, atol=1e-9)


def test_streaming_uncentered_matches_jax():
    X = matrix(n=300, p=80, seed=3)
    kw = dict(n_components=4, n_features=80, center=False, random_seed=3)
    assert_fits_match(stream(StreamingSparsePCA, X, 300, device="cpu", **kw),
                      stream(JStreaming, X, 300, **kw))


def test_streaming_randomized_solve_matches_jax_from_its_sketch():
    """p = 4,100 pads to a 4,352-wide Gram, past the exact-eigh limit: the
    randomized solve, fed the JAX package's sketch."""

    rng = np.random.default_rng(4)
    n, p, k = 200, 4100, 3
    lam = rng.gamma(2.0, 1.0, (3, p)) * (rng.random((3, p)) < 0.02)
    X = sp.csr_matrix(rng.poisson(lam[rng.integers(0, 3, n)] * 3).astype(np.float32))
    kw = dict(n_components=k, n_features=p, random_seed=5)
    jp = stream(JStreaming, X, n, **kw)
    tp = StreamingSparsePCA(device="cpu", **kw)
    pp = tp._G.shape[0]
    assert pp == 4352 > EIGH_MAX_PP
    l = k + max(10, min(k + 14, pp - k))
    key = jax.random.PRNGKey(np.uint32(5))
    tp._omega = torch.from_numpy(np.array(jax.random.normal(key, (pp, l), np.float32)))
    tp.partial_fit(X).finalize()
    assert_fits_match(tp, jp)


def test_fold_matches_no_fold():
    X = matrix(n=600, p=64, seed=12)
    kw = dict(n_components=3, n_features=64, random_seed=0, device="cpu")
    a = StreamingSparsePCA(fold_every=1, **kw)
    b = StreamingSparsePCA(fold_every=10**9, **kw)
    for r0 in range(0, 600, 150):
        a.partial_fit(X[r0:r0 + 150])
        b.partial_fit(X[r0:r0 + 150])
    a.finalize()
    b.finalize()
    assert a._G64 is not None and b._G64 is None
    assert_close_of_max(a._G64, b._G.numpy(), 1e-6)
    assert_close_of_max(a.explained_variance_, b.explained_variance_, 1e-6)
    ja = stream(JStreaming, X, 150, n_components=3, n_features=64, random_seed=0,
                fold_every=1)
    assert_close_of_max(a._G64, ja._G64, 1e-6)


def test_refit_other_k_matches_jax():
    X = matrix(n=400, p=60, seed=8)
    kw = dict(n_components=3, n_features=60, random_seed=0)
    tp = stream(StreamingSparsePCA, X, 400, device="cpu", **kw)
    jp = stream(JStreaming, X, 400, **kw)
    ev3 = tp.explained_variance_.copy()
    tp.refit(5)
    jp.refit(5)
    assert tp.explained_variance_.shape == (5,) and tuple(tp.components_.shape) == (5, 60)
    np.testing.assert_allclose(tp.explained_variance_[:3], ev3, rtol=1e-6)
    assert_fits_match(tp, jp)
    assert tp.transform(X[:50]).shape == (50, 5)
    tp.refit(3)
    assert tp.explained_variance_.shape == (3,)


def test_incremental_refit_is_one_shot():
    X = matrix(n=500, p=80, seed=11)
    inc = stream(StreamingSparsePCA, X[:300], 300, n_components=4, n_features=80,
                 device="cpu")
    ev_a = inc.explained_variance_.copy()
    inc.partial_fit(X[300:])
    assert inc.components_ is None
    inc.finalize()
    one = stream(StreamingSparsePCA, X, 500, n_components=4, n_features=80, device="cpu")
    assert not np.allclose(ev_a, inc.explained_variance_)
    np.testing.assert_allclose(inc.explained_variance_, one.explained_variance_, rtol=1e-5)
    np.testing.assert_allclose(inc.col_sums(), one.col_sums(), rtol=1e-9)


def test_payload_cache_skips_the_host_build(monkeypatch):
    X = matrix(n=700, p=90, seed=9)
    cache = {}
    kw = dict(n_components=3, n_features=90, random_seed=0, payload_cache=cache,
              device="cpu")
    a = StreamingSparsePCA(**kw)
    a.partial_fit(X, key="x").finalize()
    assert ("1dev", "x", 256) in cache

    def refuse(*args, **kwargs):
        raise AssertionError("the cached pass built a payload")

    monkeypatch.setattr(smod, "_slab_payload", refuse)
    b = StreamingSparsePCA(**kw)
    b.partial_fit(X, key="x").finalize()
    np.testing.assert_array_equal(a._G.numpy(), b._G.numpy())
    np.testing.assert_array_equal(a.explained_variance_, b.explained_variance_)
    np.testing.assert_array_equal(a.col_sums(), b.col_sums())


def test_wire_format_is_bf16_bits_and_int16_ids():
    X = matrix(n=100, p=40, seed=13)
    sl = X[:100]
    args = (sl.indptr.astype(np.int64), sl.indices.astype(np.int32),
            sl.data.astype(np.float32), 100, 40, 256)
    assert smod._bf16_exact(sl.data)
    td, tl, wt, nt = smod._slab_payload(*args, exact=True)
    f32, _, _, _ = smod._slab_payload(*args, exact=False)
    assert td.dtype == np.uint16 and tl.dtype == np.int16 and f32.dtype == np.float32
    assert td.shape == (nt * wt, smod._SLAB) and wt % 8 == 0
    wide, ids = smod._widen(torch.from_numpy(td.view(np.int16)), torch.from_numpy(tl), True)
    np.testing.assert_array_equal(wide.numpy(), f32)
    assert ids.dtype == torch.int32
    assert not smod._bf16_exact(np.array([1.0, 1.0 + 2.0**-10], np.float32))
    assert not smod._bf16_exact(np.array([np.nan], np.float32))


def test_inverse_transform_and_sparse_matrix_chunks():
    X = matrix(n=500, p=80)
    pca = StreamingSparsePCA(n_components=6, n_features=80, random_seed=2, device="cpu")
    for r0 in range(0, 500, 128):
        pca.partial_fit(SparseMatrix.from_scipy(X[r0:r0 + 128], device="cpu"))
    pca.finalize()
    T = pca.transform(X)
    R = pca.inverse_transform(T)
    assert R.shape == X.shape
    want = T @ pca.components_.numpy() + pca.mean_.numpy()
    np.testing.assert_allclose(R, want, rtol=1e-5, atol=1e-5)


def test_validation_and_guards():
    with pytest.raises(ValueError, match="n_features"):
        StreamingSparsePCA(n_components=3, device="cpu")
    with pytest.raises(ValueError, match="40960"):
        StreamingSparsePCA(n_components=3, n_features=50000, device="cpu")
    with pytest.raises(ValueError, match="col_tile"):
        StreamingSparsePCA(n_components=3, n_features=50, col_tile=4, device="cpu")
    pca = StreamingSparsePCA(n_components=3, n_features=50, device="cpu")
    with pytest.raises(RuntimeError, match="no rows"):
        pca.col_sums()
    with pytest.raises(RuntimeError, match="no rows"):
        pca.col_sums_squared()
    with pytest.raises(ValueError, match="chunk width"):
        pca.partial_fit(sp.random(10, 49, 0.5, format="csr", dtype=np.float32))
    with pytest.raises(RuntimeError, match="fitted"):
        pca.transform(sp.random(10, 50, 0.5, format="csr", dtype=np.float32))
    pca.partial_fit(sp.random(1, 50, 0.5, format="csr", dtype=np.float32))
    with pytest.raises(RuntimeError, match="variance"):
        pca.col_var()
    with pytest.raises(RuntimeError, match="2 accumulated rows"):
        pca.finalize()
    pca.partial_fit(sp.random(10, 50, 0.5, format="csr", dtype=np.float32, random_state=0))
    pca.finalize()
    pca.partial_fit(sp.random(10, 50, 0.5, format="csr", dtype=np.float32, random_state=1))
    assert pca.components_ is None
    with pytest.raises(RuntimeError, match="fitted"):
        pca.inverse_transform(np.zeros((2, 3), np.float32))


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert StreamingSparsePCA(3, 50).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            StreamingSparsePCA(3, 50)


def test_prefetch_delivers_every_item_to_a_slow_consumer():
    """The end marker waits for room like any item: a consumer that falls
    behind the worker still gets every item, in order (under a short
    thread switch interval, so the two threads interleave finely)."""

    import sys
    import time

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = []
        for item in smod._prefetch((i for i in range(40)), depth=2):
            got.append(item)
            time.sleep(0.002 * (item % 3))
        assert got == list(range(40))
    finally:
        sys.setswitchinterval(old)


def test_prefetch_reraises_and_releases_the_worker():
    import threading

    def failing():
        yield 1
        raise KeyError("boom")

    with pytest.raises(KeyError, match="boom"):
        list(smod._prefetch(failing()))

    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()

    it = smod._prefetch(endless(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()  # the consumer stops early
    assert closed.wait(timeout=10), "the worker kept running after the consumer left"


def test_slow_consumer_loses_no_slab(monkeypatch):
    """A fit whose device step is slower than the host build (the float32
    tier on the card) accumulates every slab."""

    import time

    X = matrix(n=3000, p=50, counts=False, seed=14)
    monkeypatch.setattr(smod, "_SLAB", 256)
    slow = smod._accum_slab

    def slow_accum(*args, **kwargs):
        time.sleep(0.01)
        return slow(*args, **kwargs)

    monkeypatch.setattr(smod, "_accum_slab", slow_accum)
    pca = StreamingSparsePCA(n_components=3, n_features=50, device="cpu")
    pca.partial_fit(X)
    assert pca._n == 3000
    np.testing.assert_allclose(pca.col_sums(), np.asarray(X.sum(axis=0)).ravel(), rtol=1e-5)


# -- the mesh mode -------------------------------------------------------------


@pytest.fixture
def small_slabs(monkeypatch):
    """128-row slabs in both packages, so a mesh sees several per chunk,
    and the JAX ``_prefetch`` made synchronous: its end marker drops a
    queued slab when the consumer lags (the port's waits; see
    ``test_slow_consumer_loses_no_slab``), which would make the JAX
    reference lose rows at random."""

    import single_algebra_tpu.models.streaming_pca as jmod

    monkeypatch.setattr(jmod, "_SLAB", 128)
    monkeypatch.setattr(smod, "_SLAB", 128)
    monkeypatch.setattr(jmod, "_prefetch", lambda gen, depth=2: gen)


def test_streaming_mesh_matches_unsharded(small_slabs):
    """Mesh streaming (one slab per entry, partial Grams added on the home
    device) against the single-device stream of the port."""

    from single_algebra_tpu_torch.parallel import make_mesh

    X = matrix(n=900, p=100, seed=6)
    kw = dict(n_components=4, n_features=100, random_seed=2)
    ref = stream(StreamingSparsePCA, X, 300, device="cpu", **kw)
    pca = stream(StreamingSparsePCA, X, 300, mesh=make_mesh(8, device="cpu"), **kw)
    assert pca.device == torch.device("cpu") and pca._n == 900
    assert_close_of_max(pca._G.numpy(), ref._G.numpy(), 1e-6)
    assert_close_of_max(pca.explained_variance_, ref.explained_variance_, 1e-6)
    np.testing.assert_allclose(pca.col_sums(), ref.col_sums(), rtol=1e-6, atol=1e-3)
    T, T_ref = pca.transform(X[:300]), ref.transform(X[:300])
    assert T.shape == (300, 4)
    signs = np.sign((pca.components_.numpy() * ref.components_.numpy()).sum(1))[None, :]
    assert_close_of_max(T * signs, T_ref, 1e-5)


@pytest.mark.parametrize("ndev", [1, 2, 8])
@pytest.mark.parametrize("counts", [True, False])
def test_streaming_mesh_matches_jax_mesh(small_slabs, ndev, counts):
    from single_algebra_tpu.parallel import make_mesh as jmake_mesh
    from single_algebra_tpu_torch.parallel import make_mesh

    X = matrix(n=900, p=100, counts=counts, seed=6)
    kw = dict(n_components=4, n_features=100, random_seed=2)
    tp = stream(StreamingSparsePCA, X, 300, mesh=make_mesh(ndev, device="cpu"), **kw)
    jp = stream(JStreaming, X, 300, mesh=jmake_mesh(ndev), **kw)
    assert tp._n == jp._n == 900
    assert tp._slabs_since_fold == jp._slabs_since_fold == 9  # real slabs only
    assert_close_of_max(tp._G.numpy(), np.asarray(jp._G), 1e-6)
    assert_close_of_max(tp.col_sums_squared(), jp.col_sums_squared(), 1e-6)
    signs = assert_fits_match(tp, jp)
    T, Tj = tp.transform(X[:300]), jp.transform(X[:300])
    assert T.shape == Tj.shape == (300, 4)
    assert_close_of_max(T * signs.T, Tj, 1e-5)


def test_streaming_mesh_payload_cache_and_folds(small_slabs):
    """The mesh mode caches its uploaded super-slabs under ("mesh", key)
    and folds the Gram by real slabs: 7 slabs on a 4-entry mesh are two
    steps but 7 slabs."""

    from single_algebra_tpu_torch.parallel import make_mesh

    X = matrix(n=800, p=60, seed=9)
    cache = {}
    pca = StreamingSparsePCA(3, 60, mesh=make_mesh(4, device="cpu"), fold_every=7,
                             payload_cache=cache)
    pca.partial_fit(X, key="a")
    assert list(cache) == [("mesh", "a", 256)] and len(cache[("mesh", "a", 256)]) == 2
    assert pca._G64 is not None and pca._slabs_since_fold == 0  # 7 real slabs: one fold
    pca.partial_fit(X, key="a")
    ref = StreamingSparsePCA(3, 60, device="cpu")
    ref.partial_fit(X).partial_fit(X)
    pca.finalize()
    ref.finalize()
    assert_close_of_max(pca.explained_variance_, ref.explained_variance_, 1e-6)
