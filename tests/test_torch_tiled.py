"""The tiled engine of the torch port against the JAX package.

``TiledSparseOperator``: the host payload equals the JAX operator's bit
for bit (the state carried across); the products agree with the JAX
operator's (interpret-mode Pallas kernels) and with float64 scipy; the
capacity rule is the JAX package's; ``_fit_graph`` with the JAX package's
own sketch gives the JAX fit; ``SparsePCA(engine="tiled")`` gives the
exact PCA on gapped data. (The operator on the card is held to the same
operator on the CPU in ``tests/test_torch_spmm_kernel.py``, whose CUDA
tests run without JAX.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from single_algebra_tpu import SparseMatrix as JMatrix
from single_algebra_tpu.linalg.operators import TiledSparseOperator as JTiled
from single_algebra_tpu_torch import SparseMatrix, SparsePCABuilder
from single_algebra_tpu_torch.linalg.operators import TiledSparseOperator
from single_algebra_tpu_torch.models import pca as tpca
from single_algebra_tpu_torch.types import PowerIterationNormalizer as PIN
from single_algebra_tpu_torch.types import SVDMethod

from tests.conftest import cluster_counts


def heavy(seed, n=900, p=700, density=0.02, values="frac", dtype=np.float32):
    """Random CSR with heavy rows that overflow the main level, several of
    them over one column block, so both overflow sides are wide."""

    rng = np.random.default_rng(seed)
    X = sp.random(n, p, density=density, format="lil", random_state=rng,
                  data_rvs=rng.random)
    for r in (10, 211, 400, 401, 402):
        X[r, 100:600] = rng.random(500)
    X = X.tocsr()
    if values == "counts":
        X.data = np.ceil(X.data * 8)
    elif values == "wide":  # dense enough that wt > BF16_WT_MAX
        X = (X + sp.random(n, p, density=0.12, format="csr", random_state=rng)).tocsr()
    return X.astype(dtype)


CASES = {
    "counts": dict(values="counts"),  # bf16-exact: hi only
    "frac": dict(values="frac"),  # bf16 hi + lo
    "wide": dict(values="wide"),  # f32 payload, wt > 16
}


def both(X):
    return (TiledSparseOperator.from_matrix(SparseMatrix.from_scipy(X, device="cpu")),
            JTiled.from_matrix(JMatrix.from_scipy(X)))


def bits(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("case", list(CASES))
def test_host_payload_matches_jax_bit_for_bit(case):
    X = heavy(1, **CASES[case])
    op, jop = both(X)
    assert op.meta == tuple(int(v) for v in jop.meta)
    assert op.meta[4] > 0 and op.meta[5] > 0  # both overflow sides engaged
    assert (op.tdata_lo is None) == (jop.tdata_lo is None)
    assert op._bf16 == (case != "wide")
    names = ["tdata", "tlocal", "ov_data", "ov_ids", "ovt_data", "ovt_ids"]
    if op.tdata_lo is not None:
        names.append("tdata_lo")
    for name in names:
        a, b = bits(getattr(op, name)), bits(getattr(jop, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_split_in_chunks_is_the_same(monkeypatch):
    X = heavy(2, values="frac")
    td = torch.from_numpy(TiledSparseOperator.build_host(SparseMatrix.from_scipy(X, device="cpu"))[0])
    hi, lo = TiledSparseOperator._split_payload(td, 8)
    monkeypatch.setattr(TiledSparseOperator, "_SPLIT_CHUNK", 3 * td.shape[1])
    hi2, lo2 = TiledSparseOperator._split_payload(td, 8)
    assert torch.equal(hi.view(torch.int16), hi2.view(torch.int16))
    assert torch.equal(lo.view(torch.int16), lo2.view(torch.int16))
    assert lo.any()  # the residual half is really there


def stored_matrix(op):
    """The matrix the operator's arrays hold, rebuilt in float64 on the
    host: the main level's hi (+ lo) slots and the mv-side overflow."""

    wt, nt, ct, _, ovw, _ = op.meta
    n, p = op.shape
    td = op.tdata.double() + (0 if op.tdata_lo is None else op.tdata_lo.double())
    td, tl = td[:, :n].numpy(), op.tlocal[:, :n].numpy()
    D = np.zeros((n, nt * ct))
    rows = np.arange(n)
    for s in range(nt * wt):
        ok = (tl[s] >= 0) & (tl[s] < ct)
        np.add.at(D, (rows[ok], (s // wt) * ct + tl[s][ok]), td[s][ok])
    ovd, ovi = op.ov_data[:n].double().numpy(), op.ov_ids[:n].numpy()
    for w in range(ovw):
        np.add.at(D, (rows, ovi[:, w]), ovd[:, w])
    return D[:, :p]


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("case", list(CASES))
def test_products_match_jax_and_float64(case):
    X = heavy(3, **CASES[case])
    op, jop = both(X)
    rng = np.random.default_rng(4)
    B = rng.standard_normal((X.shape[1], 12)).astype(np.float32)
    C = rng.standard_normal((X.shape[0], 12)).astype(np.float32)
    stored = stored_matrix(op)
    for name, arg, ref in (("mv", B, stored @ B.astype(np.float64)),
                           ("rmv", C, stored.T @ C.astype(np.float64))):
        for cls in (name, name.replace("mv", "mv_fast")):
            got = getattr(op, cls)(torch.from_numpy(arg))
            assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
            assert rel(got.numpy(), np.asarray(getattr(jop, cls)(jnp.asarray(arg)))) <= 1e-6, cls
        # f32-class: JAX's three-term result, and the float64 product of
        # what the payload stores
        assert rel(getattr(op, name)(torch.from_numpy(arg)).numpy(), ref) <= 1e-6, name
    if case == "counts":  # bf16-exact values: the payload is the matrix
        assert rel(op.mv(torch.from_numpy(B)).numpy(), X.astype(np.float64) @ B) <= 1e-6


def test_fast_products_are_bf16_class():
    X = heavy(5, values="frac")
    op, _ = both(X)
    B = np.random.default_rng(6).standard_normal((X.shape[1], 9)).astype(np.float32)
    ref = X.astype(np.float64) @ B
    fast = rel(op.mv_fast(torch.from_numpy(B)).numpy(), ref)
    precise = rel(op.mv(torch.from_numpy(B)).numpy(), ref)
    assert precise < 1e-5 < fast < 3e-2


def test_float64_matrix_matches_jax_float64():
    X = heavy(7, values="frac", dtype=np.float64)
    op, jop = both(X)
    assert op.tdata.dtype == torch.float64 and op.tdata_lo is None and op.dtype == torch.float64
    rng = np.random.default_rng(8)
    B = rng.standard_normal((X.shape[1], 5))
    C = rng.standard_normal((X.shape[0], 5))
    for name, arg in (("mv", B), ("mv_fast", B), ("rmv", C), ("rmv_fast", C)):
        got = getattr(op, name)(torch.from_numpy(arg))
        assert got.dtype == torch.float64
        assert rel(got.numpy(), np.asarray(getattr(jop, name)(jnp.asarray(arg)))) <= 1e-12, name
    assert rel(op.mv(torch.from_numpy(B)).numpy(), X @ B) <= 1e-12


@pytest.mark.parametrize("case", ["counts", "wide"])
def test_payload_bytes_and_fits_match_jax(case):
    X = heavy(9, **CASES[case])
    m, jm = SparseMatrix.from_scipy(X, device="cpu"), JMatrix.from_scipy(X)
    b = TiledSparseOperator.payload_bytes(m)
    assert b == JTiled.payload_bytes(jm)
    assert TiledSparseOperator.fits(m) == JTiled.fits(jm)
    assert TiledSparseOperator.fits(m, budget_bytes=b)
    assert not TiledSparseOperator.fits(m, budget_bytes=b - 1)


def test_width_passes_run_once_per_col_tile(monkeypatch):
    """The O(nnz) width passes over the structure run once per matrix and
    ``col_tile``: the gates (``fits`` at two budgets, the mesh's charge)
    and the builds read the widths the matrix keeps."""

    from single_algebra_tpu_torch import parallel as P
    from single_algebra_tpu_torch.sparse import convert as cv

    widths, overflow = [], []
    real_w, real_o = cv.tiled_split_widths, cv.tiled_overflow_col_width

    def counted_w(*a, **kw):
        widths.append(kw["col_tile"])
        return real_w(*a, **kw)

    def counted_o(*a):
        overflow.append(a[4])
        return real_o(*a)

    monkeypatch.setattr(cv, "tiled_split_widths", counted_w)
    monkeypatch.setattr(cv, "tiled_overflow_col_width", counted_o)
    m = SparseMatrix.from_scipy(heavy(9), device="cpu")
    b = TiledSparseOperator.payload_bytes(m)
    assert TiledSparseOperator.fits(m, budget_bytes=b)
    assert not TiledSparseOperator.fits(m, budget_bytes=b - 1)
    assert P.ShardedTiled.payload_bytes(m, 2) + P.ShardedTiled.form_bytes(m, 2) > 0
    op = TiledSparseOperator.from_matrix(m)
    P.ShardedTiled.from_matrix(m, P.make_mesh(2, device="cpu"))
    P.ShardedTiled.from_matrix(m, P.make_mesh(2, device="cpu"), col_tile=128)
    assert op.meta[4] > 0  # the overflow side is charged too
    assert sorted(widths) == [128, 256]
    assert overflow == [256]


def test_structure_reads_pull_no_values():
    """The capacity gates read the host structure alone: a matrix whose
    values live on its device (a value map's result) keeps them there."""

    from single_algebra_tpu_torch.linalg.gram import GramPCAEngine

    v = SparseMatrix.from_scipy(heavy(9), device="cpu").log1p_normalize()
    assert v._h_data is None
    assert TiledSparseOperator.payload_bytes(v) > 0
    GramPCAEngine._bucket_plan(v, 256)
    assert v._h_data_pulled is None


def jax_omega(seed, p, l):
    """The sketch ``single_algebra_tpu.linalg.svd.randomized_svd`` draws."""

    key = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    return np.array(jax.random.normal(key, (p, l), dtype=jnp.float32))


@pytest.mark.parametrize("density, k", [(0.004, 2), (0.1, 5)])  # bf16 hi, f32 payload
def test_fit_graph_matches_jax(density, k):
    from single_algebra_tpu.models import pca as jpca
    from single_algebra_tpu.types import PowerIterationNormalizer as JPIN
    from single_algebra_tpu.types import SVDMethod as JSVD

    X = cluster_counts(1500, 600, n_clusters=8, seed=3, density=density).astype(np.float32)
    op, jop = both(X)
    assert op._bf16 == (density < 0.01)
    mean = np.asarray(X.mean(axis=0)).ravel().astype(np.float32)
    js, jvt, jT = jpca._fit_graph(
        jop, jnp.asarray(mean), 42, k=k, method=JSVD.random(10, 7, JPIN.QR), center=True,
        steps=None, want_transform=True, tol=1e-6, lanczos_block=None,
    )
    s, vt, T = tpca._fit_graph(
        op, torch.from_numpy(mean), 42, k=k, method=SVDMethod.random(10, 7, PIN.QR),
        center=True, want_transform=True,
        omega=torch.from_numpy(jax_omega(42, X.shape[1], k + 10)),
    )
    np.testing.assert_allclose(s.numpy() ** 2, np.asarray(js) ** 2, rtol=1e-5)
    jvt, jT = np.asarray(jvt), np.asarray(jT)
    assert np.abs(vt.numpy() - jvt).max() <= 1e-4 * np.abs(jvt).max()
    assert np.abs(T.numpy() - jT).max() <= 1e-4 * np.abs(jT).max()


def test_sparse_pca_tiled_matches_exact_pca():
    X = cluster_counts(1500, 600, n_clusters=8, seed=3, density=0.1).astype(np.float32)
    k = 5
    pca = (SparsePCABuilder().n_components(k).svd_method(SVDMethod.random(10, 7, PIN.QR))
           .engine("tiled").build())
    m = SparseMatrix.from_scipy(X, device="cpu")
    T = pca.fit_transform(m)
    assert isinstance(m._operator_cache["tiled"], TiledSparseOperator)
    D = X.toarray().astype(np.float64)
    Dc = D - D.mean(axis=0)
    _, sv, vt = np.linalg.svd(Dc, full_matrices=False)
    np.testing.assert_allclose(pca.explained_variance_, sv[:k] ** 2 / (X.shape[0] - 1), rtol=1e-4)
    # scores: the centered data on the fitted components, up to sign
    ref = Dc @ pca.components_.numpy().astype(np.float64).T
    assert T.shape == (X.shape[0], k) and torch.isfinite(T).all()
    assert rel(T.numpy(), ref) <= 1e-5
    T2 = pca.transform(m)  # the cached operator projects again
    assert rel(T2.numpy(), T.numpy()) <= 1e-6
