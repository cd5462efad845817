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
from single_algebra_tpu_torch.models import StreamingSparsePCA
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


def blobs(n_per, n_clusters=3, d=10, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d)) * 12.0
    x = np.vstack([c + rng.standard_normal((n_per, d)) for c in centers])
    return x.astype(np.float32), np.repeat(np.arange(n_clusters), n_per)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("mode", ["exact", "knn"])
def test_cuda_tsne_runs_on_the_card(cuda, mode):
    """``tsne.run`` with no device runs on the card, separates planted
    blobs, repeats bit for bit, and its gradient at a seeded y agrees with
    a float64 evaluation on the card."""

    from single_algebra_tpu_torch.models import tsne

    x, labels = blobs(200)
    cfg = tsne.TSNEConfig(perplexity=15.0, epochs=300, exaggeration_epochs=100, mode=mode)
    y = tsne.run(x, cfg)
    assert y.device.type == "cuda" and bool(torch.isfinite(y).all())
    assert torch.equal(y, tsne.run(x, cfg))
    yn = y.cpu().numpy()
    cents = np.stack([yn[labels == c].mean(0) for c in range(3)])
    within = np.mean([np.linalg.norm(yn[labels == c] - cents[c], axis=1).mean()
                      for c in range(3)])
    d = np.linalg.norm(cents[:, None] - cents[None], axis=-1)[np.triu_indices(3, 1)]
    assert d.min() / within > 3.0
    xt = torch.from_numpy(x).to(cuda)
    yt = torch.randn((len(x), 2), generator=torch.Generator(cuda).manual_seed(1),
                     device=cuda)
    if mode == "exact":
        p = tsne._exact_affinities(xt, cfg)
        g = tsne._exact_grad(yt, p, 12.0)
        g64 = tsne._exact_grad(yt.double(), p.double(), 12.0)
    else:
        src, dst, val, lengths = tsne._knn_affinities(xt, cfg)
        block = tsne._knn_block(len(x), cfg)
        g = tsne._knn_grad(yt, src, dst, val, 12.0, block=block, lengths=lengths)
        g64 = tsne._knn_grad(yt.double(), src, dst, val.double(), 12.0, block=block,
                             lengths=lengths)
        assert torch.equal(g, tsne._knn_grad(yt, src, dst, val, 12.0, block=block,
                                             lengths=lengths))
    assert float((g.double() - g64).abs().max() / g64.abs().max()) <= 1e-4


@pytest.mark.requires_cuda
def test_cuda_streaming_pca_runs_on_the_card(cuda):
    """``StreamingSparsePCA`` with no device: bf16-exact counts densify to
    bf16 and their scores to float32, log values to float32 in both
    passes; the model is the CPU stream's."""

    X = clustered_counts(20000, 300, seed=8)
    for values, fit_dtype in ((X, "bfloat16"), (X.copy(), "float32")):
        if fit_dtype == "float32":
            values.data = np.log1p(values.data) * np.float32(1.37)
        ref = StreamingSparsePCA(4, 300, device="cpu")
        pca = StreamingSparsePCA(4, 300)
        cuda_lib.reset_launch_counts()
        for r0 in range(0, 20000, 7000):
            pca.partial_fit(values[r0:r0 + 7000])
            ref.partial_fit(values[r0:r0 + 7000])
        pca.finalize()
        ref.finalize()
        T = pca.transform(values)
        slabs = sum(-(-min(7000, 20000 - r0) // 8192) for r0 in range(0, 20000, 7000))
        assert cuda_lib.densify_launches_by_dtype == (
            {fit_dtype: slabs, "float32": slabs} if fit_dtype == "bfloat16"
            else {"float32": 2 * slabs})
        assert pca.components_.device.type == "cuda" and T.shape == (20000, 4)
        np.testing.assert_allclose(pca.explained_variance_, ref.explained_variance_,
                                   rtol=1e-5)
        Tr = ref.transform(values)
        signs = np.sign((T * Tr).sum(0))
        assert np.abs(T * signs - Tr).max() <= 1e-4 * np.abs(Tr).max()


@pytest.mark.requires_cuda
def test_cuda_small_gram_eigh_matches_float64(cuda):
    """The small-Gram solve on the card: cuSOLVER's float32 ``eigh`` left
    8.1e-5 relative error in this centered Gram's top eigenvalue, so
    ``topk_psd_eigh`` decomposes in float64 there."""

    from single_algebra_tpu_torch.linalg.gram import topk_psd_eigh

    X = clustered_counts(20000, 300, seed=8).toarray().astype(np.float64)
    G = torch.from_numpy(X.T @ X).float().to(cuda)
    mu = torch.from_numpy(X.mean(axis=0)).float().to(cuda)
    s, vt = topk_psd_eigh(G - 20000.0 * (mu[:, None] * mu[None, :]), 4)
    assert s.dtype == vt.dtype == torch.float32 and tuple(vt.shape) == (4, 300)
    ev = s.double().cpu().numpy() ** 2
    ev_true = np.linalg.svd(X - X.mean(axis=0), compute_uv=False)[:4] ** 2
    assert np.abs(ev - ev_true).max() <= 1e-6 * ev_true[0]


def _card_mesh(cuda, n):
    from single_algebra_tpu_torch.parallel import Mesh

    return Mesh((torch.device("cuda", torch.cuda.current_device()),) * n)


@pytest.mark.requires_cuda
def test_cuda_mesh_of_one_card_equals_the_single_card_fit(cuda):
    """A 2-entry mesh on one card: the Gram engine's sharded fit is the
    single-card Gram fit, the tiled and densified engines' sharded fits
    (the same sketch: both draw it on the home device) are the single-card
    fits; the tiled kernels launch once per slab and product."""

    from single_algebra_tpu_torch.parallel import sharded_gram_pca, sharded_pca_fit_transform

    X = clustered_counts(6000, 300, seed=9)
    mesh = _card_mesh(cuda, 2)
    method = SVDMethod.random(10, 7, PIN.QR)
    gram = SparsePCABuilder().n_components(4).engine("gram").svd_method(method).build()
    T1 = gram.fit_transform(SparseMatrix.from_scipy(X))
    cuda_lib.reset_launch_counts()
    res = sharded_gram_pca(SparseMatrix.from_scipy(X), mesh, n_components=4)
    assert cuda_lib.launch_counts["tiled_ell_densify_t"] > 0
    np.testing.assert_allclose(res.explained_variance.cpu().numpy(), gram.explained_variance_,
                               rtol=1e-6)
    assert float((res.transformed - T1).abs().max() / T1.abs().max()) <= 1e-5
    for engine in ("tiled", "dense"):
        single = SparsePCABuilder().n_components(4).engine(engine).svd_method(method).build()
        T1 = single.fit_transform(SparseMatrix.from_scipy(X))
        cuda_lib.reset_launch_counts()
        res = sharded_pca_fit_transform(SparseMatrix.from_scipy(X), 4, mesh=mesh,
                                        engine=engine)
        if engine == "tiled":  # 1 + 7 fast + 1 precise mv, 7 fast + 1 precise rmv, per slab
            assert cuda_lib.launch_counts["tiled_ell_spmm_t"] == 2 * 9
            assert cuda_lib.launch_counts["tiled_ell_rmv_t"] == 2 * 8
        assert res.transformed.device.type == "cuda"
        np.testing.assert_allclose(res.explained_variance.cpu().numpy(),
                                   single.explained_variance_, rtol=1e-5)
        assert float((res.transformed - T1).abs().max() / T1.abs().max()) <= 1e-4


@pytest.mark.requires_cuda
def test_cuda_sharded_fits_repeat_bit_for_bit(cuda):
    from single_algebra_tpu_torch.parallel import sharded_gram_pca, sharded_pca_fit_transform

    X = clustered_counts(5000, 260, seed=10)
    mesh = _card_mesh(cuda, 3)
    m = SparseMatrix.from_scipy(X)
    for fit in (lambda: sharded_gram_pca(m, mesh, n_components=4),
                lambda: sharded_pca_fit_transform(m, 4, mesh=mesh, engine="tiled"),
                lambda: sharded_pca_fit_transform(m, 4, mesh=mesh, engine="dense",
                                                  svd_method=SVDMethod.lanczos())):
        a, b = fit(), fit()
        assert torch.equal(a.transformed, b.transformed)
        assert torch.equal(a.explained_variance, b.explained_variance)


@pytest.mark.requires_cuda
def test_cuda_make_mesh_never_repeats_a_card(cuda):
    from single_algebra_tpu_torch.parallel import make_mesh

    count = torch.cuda.device_count()
    assert make_mesh(device="cuda").devices == tuple(
        torch.device("cuda", i) for i in range(count))
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh(count + 1, device="cuda")


# -- the single-cell workflow ----------------------------------------------------


@pytest.mark.requires_cuda
def test_cuda_workflow_defaults_run_on_the_card(cuda):
    """QC, HVG, connectivities, Leiden, KMeans and UMAP with no device run
    on the card and agree with the same calls on the CPU: counts exact,
    the HVG scores within 1e-5, kNN distances within 1e-4, the graph's
    pattern identical, Leiden
    (native) finding the 4 blobs, KMeans from the same centers within
    1e-5, UMAP repeating bit for bit."""

    import single_algebra_tpu_torch as tsat
    from single_algebra_tpu_torch import neighbors
    from single_algebra_tpu_torch.models import UMAP, UMAPConfig
    from single_algebra_tpu_torch.models import kmeans as kmod

    X = clustered_counts(3000, 300, seed=11)
    m, mc = SparseMatrix.from_scipy(X), SparseMatrix.from_scipy(X, device="cpu")
    obs, _ = tsat.calculate_qc_metrics(m)
    cobs, _ = tsat.calculate_qc_metrics(mc)
    np.testing.assert_array_equal(obs["total_counts"], cobs["total_counts"])
    norm = m.normalize(m.sum_row(), 1e4, tsat.Direction.ROW).log1p_normalize()
    cnorm = mc.normalize(mc.sum_row(), 1e4, tsat.Direction.ROW).log1p_normalize()
    h, ch = (tsat.highly_variable_genes(a, n_top_genes=60) for a in (norm, cnorm))
    np.testing.assert_allclose(h.dispersions_norm, ch.dispersions_norm, rtol=1e-5, atol=1e-5)
    x, labels = blobs(400, n_clusters=4, d=12, seed=3)
    # |x|^2 + |y|^2 - 2 x.y in float32 at |x|^2 ~ 1,700 and d^2 ~ 10: two
    # devices' GEMMs part by ~1e-5 of d
    d, _ = neighbors.knn(x, 12)
    cd, _ = neighbors.knn(x, 12, device="cpu")
    assert float((d.cpu() - cd).abs().max() / cd.abs().max()) <= 1e-4
    S = neighbors.connectivities(x, 12)
    cS = neighbors.connectivities(x, 12, device="cpu")
    np.testing.assert_array_equal(S.indices, cS.indices)
    # the smooth-kNN calibration divides distance rounding by sigma: the
    # weights of two devices' float32 kNN part by up to ~1e-3
    assert np.abs(S.data - cS.data).max() <= 1e-2
    lr = tsat.leiden(S, resolution=0.5)
    assert lr.backend == "native" and lr.n_communities == 4
    xt = torch.from_numpy(x).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    x2, w = kmod._row_sq_norms(xt), torch.ones(len(x), device=cuda)
    C0 = kmod._plusplus_init(gen, xt, x2, w, 4)
    tol2 = kmod.KMeans(4)._tol2(xt)
    C, lab, _, _ = kmod._lloyd(xt, x2, tol2, C0, w, k=4, max_iter=100)
    xc = xt.cpu()
    Cc, labc, _, _ = kmod._lloyd(xc, kmod._row_sq_norms(xc), tol2, C0.cpu(), w.cpu(), k=4,
                                 max_iter=100)
    np.testing.assert_array_equal(lab.cpu().numpy(), labc.numpy())
    assert float((C.cpu() - Cc).abs().max() / Cc.abs().max()) <= 1e-5
    cfg = UMAPConfig(n_epochs=60)
    Y = UMAP(cfg).fit_transform(x)
    assert Y.device.type == "cuda" and torch.equal(Y, UMAP(cfg).fit_transform(x))


@pytest.mark.requires_cuda
def test_cuda_ivf_and_umap_epoch_match_the_cpu(cuda):
    """The IVF index on the card finds the card's exact neighbors (recall
    at least 0.95, ties aside) and repeats bit for bit; one UMAP epoch on
    the card is within 1e-4 of max |update| of a float64 CPU epoch with
    the same draws."""

    from single_algebra_tpu_torch import neighbors
    from single_algebra_tpu_torch.models import umap as umod

    x, _ = blobs(1500, n_clusters=6, d=10, seed=4)
    d, i = neighbors.ivf_knn(x, 10, n_lists=40, n_probe=8)
    assert d.device.type == "cuda"
    assert torch.equal(i, neighbors.ivf_knn(x, 10, n_lists=40, n_probe=8)[1])
    ed_, _ = neighbors.knn(x, 10)
    hits = (d <= ed_[:, -1:] * (1 + 1e-5)).sum(dim=1).clamp(max=10).sum()
    assert float(hits) / d.numel() >= 0.95
    S = neighbors.connectivities(x, 10, device="cpu")
    ed, ed_cpu = umod._edges_of(S, len(x), cuda), umod._edges_of(S, len(x), "cpu")
    a, b = umod._fit_ab(1.0, 0.1)
    gen = torch.Generator(device=cuda).manual_seed(9)
    Y = 10 * torch.randn((len(x), 2), generator=gen, device=cuda)
    active = torch.rand(ed.heads.shape[0], generator=gen, device=cuda) < ed.weights
    negs = torch.randint(0, len(x), (ed.heads.shape[0], 5), generator=gen, device=cuda)
    upd = umod._layout_epoch(Y, ed, active, negs, 1.0, a, b) - Y
    assert torch.equal(upd, umod._layout_epoch(Y, ed, active, negs, 1.0, a, b) - Y)
    Y64 = Y.cpu().double()
    upd64 = umod._layout_epoch(Y64, ed_cpu, active.cpu(), negs.cpu(), 1.0, a, b) - Y64
    assert float((upd.cpu().double() - upd64).abs().max() / upd64.abs().max()) <= 1e-4


@pytest.mark.requires_cuda
def test_cuda_wilcoxon_block_repeats_bit_for_bit(cuda):
    """The Wilcoxon rank sums on the card: float64 sums of half-integer
    ranks are exact, so a repeat and the CPU give the same bits, whatever
    order the card's scatter-adds take."""

    from single_algebra_tpu_torch import de

    X = clustered_counts(4000, 200, seed=12)
    X.data = np.log1p(X.data)
    labels = np.random.default_rng(0).integers(0, 6, 4000)
    m, mc = SparseMatrix.from_scipy(X), SparseMatrix.from_scipy(X, device="cpu")
    codes = np.unique(labels, return_inverse=True)[1]
    plans = de._wilcoxon_plans(codes, list(range(6)), None, 6)
    mask, cmap, cols = plans[0]
    outs = []
    for mm in (m, m, mc):
        lay = mm._layout_for("col")
        dev = lay.ell_data.device
        outs.append(de._rank_block_sparse(
            lay.ell_data[:64], lay.ell_ids[:64], lay.row_nnz[:64],
            torch.as_tensor(mask, device=dev), torch.as_tensor(cmap, device=dev),
            torch.as_tensor(np.bincount(codes, minlength=6), dtype=torch.float64, device=dev),
            len(codes), 6))
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    for a, b in zip(outs[0], outs[2]):
        assert torch.equal(a.cpu(), b)
    got = de.rank_genes_groups(m, labels, method="wilcoxon")
    want = de.rank_genes_groups(mc, labels, method="wilcoxon")
    for g in want.names:
        np.testing.assert_array_equal(got.scores[g], want.scores[g])


@pytest.mark.requires_cuda
def test_cuda_lsi_auto_takes_the_tiled_kernels(cuda, monkeypatch):
    """Past 40,960 columns, with the dense form over budget, ``auto``
    takes the tiled engine: TF-IDF values split into hi and lo payloads,
    both kernels launch, and the singular values agree with the CPU run
    of the kernels' plain versions from the same sketch within 1e-5."""

    from single_algebra_tpu_torch.linalg import svd as tsvd
    from single_algebra_tpu_torch.linalg.operators import DensifiedOperator, TiledSparseOperator
    from single_algebra_tpu_torch.models import lsi
    from single_algebra_tpu_torch.ops import spmm_kernel

    rng = np.random.default_rng(13)
    n, p = 3000, 41_000
    prog = rng.random((5, p)) < 0.01
    lab = rng.integers(0, 5, n)
    X = sp.csr_matrix((rng.random((n, p)) < 0.3 * prog[lab]).astype(np.float32))
    monkeypatch.setattr(DensifiedOperator, "hbm_budget_bytes", staticmethod(lambda d: 100 << 20))
    cpu_sketch = tsvd.gaussian_sketch
    monkeypatch.setattr(tsvd, "gaussian_sketch", lambda p_, l, seed, *, dtype, device:
                        cpu_sketch(p_, l, seed, dtype=dtype, device="cpu").to(device))
    engines = []
    real = tpca.make_engine_operator
    monkeypatch.setattr(tpca, "make_engine_operator",
                        lambda m_, e: engines.append(real(m_, e)) or engines[-1])
    spmm_kernel.reset_launch_counts()
    # the 5 programs' components (4 after the depth one): past them the
    # spectrum is flat noise, which no randomized solve resolves to 1e-5
    got = lsi(SparseMatrix.from_scipy(X), 4)
    counts = dict(spmm_kernel.launch_counts)
    assert isinstance(engines[0], TiledSparseOperator) and engines[0].tdata_lo is not None
    assert counts["tiled_ell_spmm_t"] > 0 and counts["tiled_ell_rmv_t"] > 0
    want = lsi(SparseMatrix.from_scipy(X, device="cpu"), 4, engine="tiled")
    np.testing.assert_allclose(got.singular_values, want.singular_values, rtol=1e-5)


def sbm(sizes, p_in=0.5, p_out=0.01, seed=0):
    """Stochastic block model adjacency (symmetric, unweighted) and labels."""

    rng = np.random.default_rng(seed)
    labels = np.repeat(np.arange(len(sizes)), sizes)
    prob = np.where(labels[:, None] == labels[None, :], p_in, p_out)
    upper = np.triu(rng.random((len(labels),) * 2) < prob, k=1)
    return sp.csr_matrix((upper | upper.T).astype(np.float32)), labels


@pytest.mark.requires_cuda
def test_cuda_draw_graph_matches_the_cpu_and_repeats(cuda):
    from single_algebra_tpu_torch.models import draw_graph

    A, labels = sbm([60, 60, 60], seed=1)
    init = np.random.default_rng(0).normal(size=(180, 2)).astype(np.float32) * 13.0
    got = draw_graph(A, n_iter=1, init=init)
    want = draw_graph(A, n_iter=1, init=init, device="cpu")
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    y1, y2 = draw_graph(A, n_iter=200, seed=3), draw_graph(A, n_iter=200, seed=3)
    np.testing.assert_array_equal(y1, y2)
    cents = np.stack([y1[labels == c].mean(0) for c in range(3)])
    within = np.mean([np.linalg.norm(y1[labels == c] - cents[c], axis=1).mean()
                      for c in range(3)])
    d = np.linalg.norm(cents[:, None] - cents[None, :], axis=-1)
    assert d[np.triu_indices(3, 1)].min() / within > 2.0


@pytest.mark.requires_cuda
def test_cuda_nmf_runs_on_the_densified_payload(cuda):
    from single_algebra_tpu_torch.models import NMF

    X = clustered_counts(2000, 300, 3)
    m = SparseMatrix.from_scipy(X)
    model = NMF(4, max_iter=100, tol=0.0)
    W = model.fit_transform(m)
    assert model.engine_ == "DensifiedOperator"
    assert m._operator_cache["auto"] is m._operator_cache["dense"]  # one payload
    cpu = NMF(4, max_iter=100, tol=0.0)
    cpu.fit(SparseMatrix.from_scipy(X, device="cpu"))
    # the card's randomized init draws its own sketch: compare the fits' losses
    np.testing.assert_allclose(model.reconstruction_err_, cpu.reconstruction_err_, rtol=1e-2)
    direct = np.linalg.norm(X.toarray() - W @ model.components_)
    np.testing.assert_allclose(model.reconstruction_err_, direct, rtol=1e-4)


@pytest.mark.requires_cuda
def test_cuda_harmony_and_mesh_stages_match_the_cpu(cuda):
    from single_algebra_tpu_torch.models import harmony as th
    from single_algebra_tpu_torch.parallel import Mesh, ShardedSpMM, make_mesh, mesh_qc_metrics

    harmony_mod = __import__("importlib").import_module("single_algebra_tpu_torch.models.harmony")
    rng = np.random.default_rng(4)
    Z = (rng.normal(0, 6, (3, 8))[rng.integers(0, 3, 600)]
         + rng.normal(0, 1, (600, 8))).astype(np.float32)
    batch = np.where(rng.random(600) < 0.5, "a", "b")
    Z[batch == "b"] += 3.0
    Y = rng.normal(0, 1, (6, 8)).astype(np.float32)
    Y /= np.linalg.norm(Y, axis=1, keepdims=True)
    B, codes = harmony_mod._batch_codes(batch, 600)
    kw = dict(sigma=0.1, theta=2.0, lam=1.0, max_rounds=3, max_kmeans_iters=20,
              block_frac=0.05, eps_kmeans=1e-5, eps_harmony=1e-4, seed=0)
    got = harmony_mod._harmony_from(torch.from_numpy(Z).to(cuda), codes, B,
                                    torch.from_numpy(Y).to(cuda), **kw)
    want = harmony_mod._harmony_from(torch.from_numpy(Z), codes, B, torch.from_numpy(Y), **kw)
    assert got.n_rounds == want.n_rounds
    assert np.abs(got.embedding - want.embedding).max() <= 1e-4 * np.abs(want.embedding).max()
    assert th(Z, batch, n_clusters=6, max_rounds=2).embedding.shape == Z.shape

    X = clustered_counts(1000, 120, 5)
    mito = np.zeros(120, bool)
    mito[::7] = True
    card = mesh_qc_metrics(ShardedSpMM.from_matrix(SparseMatrix.from_scipy(X), Mesh((cuda,) * 4)),
                           qc_vars={"mito": mito})
    host = mesh_qc_metrics(ShardedSpMM.from_matrix(SparseMatrix.from_scipy(X, device="cpu"),
                                                   make_mesh(4, device="cpu")),
                           qc_vars={"mito": mito})
    for a, b in zip(card, host):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.requires_cuda
def test_cuda_densified_products_reduce_in_blocks(cuda):
    """The densified engine's precise products on the card reduce in blocks
    of ``operators._RED_BLOCK`` along the summed axis: both stay within
    1e-6 of float64 past several blocks."""

    from single_algebra_tpu_torch.linalg.operators import _RED_BLOCK, DensifiedOperator

    rng = np.random.default_rng(6)
    X = sp.random(3 * _RED_BLOCK + 123, 2 * _RED_BLOCK + 17, density=0.01, format="csr",
                  dtype=np.float32, random_state=rng,
                  data_rvs=lambda k: rng.integers(1, 50, k).astype(np.float32))
    op = DensifiedOperator.from_matrix(SparseMatrix.from_scipy(X))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    B = torch.rand((X.shape[1], 20), generator=gen, device=cuda)
    C = torch.rand((X.shape[0], 20), generator=gen, device=cuda)
    A = torch.from_numpy(X.toarray()).to(cuda).double()
    for got, want in ((op.mv_precise(B), A @ B.double()), (op.rmv_precise(C), A.T @ C.double())):
        assert float((got.double() - want).abs().max() / want.abs().max()) <= 1e-6


@pytest.mark.requires_cuda
def test_cuda_padded_stride_agrees_with_the_unpadded_form(cuda):
    """On the card the dense half of 1,001 columns is stored in rows of
    1,008 and kept as its [n, 1001] view; cuBLAS's products over it and
    the column statistics equal those over the same half stored
    contiguously (1e-6 of max |result|: another kernel may sum in another
    order)."""

    from single_algebra_tpu_torch.linalg.operators import DensifiedOperator

    X = clustered_counts(20_000, 1001, seed=5)
    op = DensifiedOperator.from_matrix(SparseMatrix.from_scipy(X))
    assert op.lo is None and tuple(op.hi.shape) == X.shape and op.hi.stride() == (1008, 1)
    plain = DensifiedOperator(op.hi.contiguous(), None, X.shape)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(4)
    B = torch.randn((1001, 60), generator=gen, device=cuda)
    C = torch.randn((20_000, 60), generator=gen, device=cuda)
    for name, arg in (("mv", B), ("rmv", C), ("mv_precise", B), ("rmv_precise", C)):
        got, ref = getattr(op, name)(arg), getattr(plain, name)(arg)
        assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max()), name
    for got, ref in zip(op.col_stats(), plain.col_stats()):
        assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())
