"""UMAP — Uniform Manifold Approximation and Projection.

Counterpart of ``single_algebra_tpu/models/umap.py`` (McInnes, Healy,
Melville 2018), on the card by default:

* **kNN graph**: exact, ``[block, n]`` squared-distance tiles (one GEMM
  each) + ``topk`` (:func:`_knn_graph`); above 200,000 rows
  ``fuzzy_connectivities`` takes the IVF index (``neighbors.ivf_knn``).
* **Fuzzy simplicial set**: the smooth-kNN calibration is a fixed 64-step
  bisection (:func:`_smooth_knn`); the union ``W + W^T - W o W^T`` is host
  scipy algebra over the n*k edge list, in float64.
* **Layout**: negative-sampling SGD, every edge each epoch, attraction
  gated by a per-edge Bernoulli draw with probability the edge weight,
  ``negative_sample_rate`` uniform negatives per edge, both endpoints
  moved. Per-edge gradients reduce into per-point updates with two
  ``torch.segment_reduce`` sums over sorted segments (the heads, CSR
  sorted, and the tails through a fixed permutation): no float atomics,
  so a run repeats bit for bit on the card.

The JAX package draws the edge gates and negatives from ``jax.random``,
which torch cannot reproduce: one epoch (:func:`_layout_epoch`,
:func:`_transform_epoch`) takes its draws ``active`` / ``negs`` as
arguments, and the drivers draw them from a ``torch.Generator`` seeded
with ``random_seed + 1`` (layout) or ``+ 2`` (transform). The PCA init
applies a sign rule (each right singular vector's largest-magnitude entry
positive), which LAPACK drivers do not fix.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..types import precision_policy

__all__ = ["UMAP", "UMAPConfig"]


def _fit_ab(spread: float, min_dist: float) -> tuple[float, float]:
    """Least-squares fit of ``1 / (1 + a d^(2b))`` to the fuzzy membership
    target (exp decay past min_dist): umap-learn's find_ab_params, host
    scipy as in the JAX package."""

    from scipy.optimize import curve_fit

    xv = np.linspace(0, spread * 3, 300)
    yv = np.ones_like(xv)
    mask = xv >= min_dist
    yv[mask] = np.exp(-(xv[mask] - min_dist) / spread)

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2 * b))

    (a, b), _ = curve_fit(curve, xv, yv, p0=(1.0, 1.0), maxfev=5000)
    return float(a), float(b)


def _knn_graph(X: torch.Tensor, *, k: int, block: int = 2048):
    """Exact kNN excluding self: ``(dists [n, k], idx [n, k])``, nearest
    first, ``idx`` int32.

    ``[block, n]`` squared-distance tiles ``|x|^2 + |y|^2 - 2 x.y``
    computed in float32 (one GEMM each), the self pair masked to inf,
    ``topk`` of the negated tile, and ``sqrt(max(d, 0))`` at the end.
    Memory O(block * n). Among equal distances the order of the ids is
    torch's, which may differ from ``lax.top_k``'s."""

    X = X.float()
    n = X.shape[0]
    sq = (X * X).sum(dim=1)
    d_all = torch.empty((n, k), dtype=torch.float32, device=X.device)
    i_all = torch.empty((n, k), dtype=torch.int32, device=X.device)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        d2 = sq[r0:r1, None] + sq[None, :]
        d2.addmm_(X[r0:r1], X.T, alpha=-2.0)
        torch.diagonal(d2, offset=r0).fill_(float("inf"))
        nd, ni = torch.topk(-d2, k, dim=1)
        d_all[r0:r1] = -nd
        i_all[r0:r1] = ni.int()
    return torch.sqrt(torch.clamp(d_all, min=0.0)), i_all


def _metric_prep(X: torch.Tensor, metric: str) -> torch.Tensor:
    """'cosine' runs the same euclidean tiles on L2-normalized rows (unit
    sphere euclidean is monotone in cosine distance; convert with
    :func:`_to_cosine_dist`). Zero rows stay zero."""

    if metric == "euclidean":
        return X
    if metric == "cosine":
        nrm = torch.linalg.norm(X, dim=1, keepdim=True)
        return X / torch.clamp(nrm, min=1e-12)
    raise ValueError(f"unknown metric {metric!r}; expected 'euclidean' or 'cosine'")


def _to_cosine_dist(d_euclidean: torch.Tensor) -> torch.Tensor:
    """Unit-sphere euclidean -> cosine distance: 1 - cos = d^2 / 2."""

    return d_euclidean * d_euclidean * 0.5


def _smooth_knn(dists: torch.Tensor, *, n_iter: int = 64):
    """Per-point (rho, sigma): rho = nearest nonzero distance, sigma solves
    ``sum_j exp(-(d_ij - rho)/sigma) = log2(k)`` by a fixed 64-step
    bisection, floored at 1e-3 of the mean distance (umap-learn
    smooth_knn_dist). In float32, as the JAX package computes it."""

    dists = dists.float()
    k = dists.shape[1]
    target = torch.log2(torch.tensor(float(k), dtype=torch.float32, device=dists.device))
    pos = torch.where(dists > 0, dists, torch.full_like(dists, float("inf")))
    pmin = pos.min(dim=1).values
    rho = torch.where(torch.isfinite(pmin), pmin, torch.zeros_like(pmin))
    excess = torch.clamp(dists - rho[:, None], min=0.0)
    lo = torch.full_like(rho, 1e-8)
    hi = torch.full_like(rho, 1e4)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        too_big = torch.exp(-excess / mid[:, None]).sum(dim=1) > target
        lo, hi = torch.where(too_big, lo, mid), torch.where(too_big, mid, hi)
    sigma = 0.5 * (lo + hi)
    return rho, torch.clamp(sigma, min=float(1e-3 * dists.mean()))


def _memberships(dists: torch.Tensor):
    """The directed membership weights ``exp(-max(d - rho, 0) / sigma)``."""

    rho, sigma = _smooth_knn(dists)
    return torch.exp(-torch.clamp(dists - rho[:, None], min=0.0) / sigma[:, None])


@precision_policy()
def fuzzy_connectivities(
    X, k: int, *, block: int = 2048, method: str = "auto",
    metric: str = "euclidean", mesh=None, device="cuda",
):
    """Symmetric fuzzy-simplicial-set weights as scipy CSR ``[n, n]``
    (scanpy's ``pp.neighbors`` connectivities): the kNN, the (rho, sigma)
    calibration and the directed memberships on the device, the union
    ``W + W^T - W o W^T`` on the host in float64.

    ``method``: 'exact' (blocked O(n^2 d) kNN; over ``mesh``'s row slabs
    when a mesh is given), 'ivf' (``neighbors.ivf_knn``), or 'auto' (the
    IVF index above 200,000 rows). A numpy input goes to ``device``."""

    import scipy.sparse as sp

    if method not in ("auto", "exact", "ivf"):
        raise ValueError(f"Unknown kNN method {method!r}")
    if mesh is not None:
        device = mesh.home
    X = torch.as_tensor(X, device=device) if not isinstance(X, torch.Tensor) else X
    X = _metric_prep(X.float(), metric)
    n = X.shape[0]
    if method == "ivf" or (method == "auto" and n > 200_000):
        from ..neighbors import ivf_knn

        dists, idx = ivf_knn(X, k)
    elif mesh is not None:
        from ..neighbors import _knn_graph_mesh, _mesh_blocks

        dists, idx = _knn_graph_mesh(X, k=k, mesh=mesh, **_mesh_blocks(n, mesh, block))
    else:
        dists, idx = _knn_graph(X, k=k, block=block)
    if metric == "cosine":
        dists = _to_cosine_dist(dists)
    W = _memberships(dists)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = idx.cpu().numpy().astype(np.int64).ravel()
    vals = W.cpu().numpy().astype(np.float64).ravel()
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    return A + A.T - A.multiply(A.T)


_EPS = 1e-3


def _consts(a: float, b: float):
    """The layout's scalars as the JAX package forms them, in float32:
    ``a``, ``b``, ``-2ab``, ``2b`` and ``b - 1`` (a float64 run then
    repeats the JAX package's float64 run, not just its float32 one)."""

    a32, b32 = np.float32(a), np.float32(b)
    return (float(a32), float(b32), float(np.float32(-2.0) * a32 * b32),
            float(np.float32(2.0) * b32), float(b32 - np.float32(1.0)))


def _alpha(lr: float, e: int, n_epochs: int) -> float:
    """Epoch ``e``'s learning rate ``lr (1 - e / n_epochs)`` in float32."""

    return float(np.float32(lr) * (np.float32(1.0) - np.float32(e) / np.float32(n_epochs)))


def _attraction(d2, a, b, c_att, b_m1):
    return (c_att * d2 ** b_m1) / (1.0 + a * d2 ** b)


def _repulsion(dn2, a, b, c_rep):
    return c_rep / ((_EPS + dn2) * (1.0 + a * dn2 ** b))


def _transform_epoch(Y, Ytrain, idx, active, negs, alpha, a: float, b: float):
    """One epoch of the one-sided layout of new points ``Y [m, dim]``:
    their kNN memberships (gated by ``active [m, k]``) attract toward the
    frozen ``Ytrain``, the training rows ``negs [m, neg_rate]`` repel."""

    a, b, c_att, c_rep, b_m1 = _consts(a, b)
    dvec = Y[:, None, :] - Ytrain[idx]
    d2 = (dvec * dvec).sum(dim=2, keepdim=True)
    g_att = _attraction(d2, a, b, c_att, b_m1)
    g_att = torch.where(active[:, :, None], g_att, torch.zeros_like(g_att))
    grad = torch.clamp(g_att * dvec, -4.0, 4.0).sum(dim=1)
    dn = Y[:, None, :] - Ytrain[negs]
    dn2 = (dn * dn).sum(dim=2, keepdim=True)
    grad = grad + torch.clamp(_repulsion(dn2, a, b, c_rep) * dn, -4.0, 4.0).sum(dim=1)
    return Y + alpha * grad


def _transform_layout(Ynew, Ytrain, idx, w, gen: torch.Generator, *, epochs: int,
                      neg_rate: int, a: float, b: float, lr: float):
    """``epochs`` of :func:`_transform_epoch`, the gates ``uniform < w`` and
    the negatives drawn from ``gen`` each epoch."""

    m, k = w.shape
    n_train = Ytrain.shape[0]
    Y = Ynew
    for e in range(epochs):
        active = torch.rand((m, k), generator=gen, device=w.device) < w
        negs = torch.randint(0, n_train, (m, neg_rate), generator=gen, device=w.device)
        Y = _transform_epoch(Y, Ytrain, idx, active, negs, _alpha(lr, e, epochs), a, b)
    return Y


class _Edges:
    """The layout's edge list on the device: ``heads`` sorted ascending
    (CSR row order), ``tails``, ``weights`` (max 1), the permutation
    ``tperm = argsort(tails)`` with ``tails_sorted = tails[tperm]``, and
    the segment lengths of both sorted lists over the n points."""

    def __init__(self, heads, tails, weights, n: int, device):
        tperm = np.argsort(tails, kind="stable")

        def put(a, dt=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)

        self.n = n
        self.heads = put(heads)
        self.tails = put(tails)
        self.weights = put(weights, torch.float32)
        self.tperm = put(tperm)
        self.len_h = put(np.bincount(heads, minlength=n))
        self.len_t = put(np.bincount(tails[tperm], minlength=n))


def _layout_epoch(Y, ed: _Edges, active, negs, alpha, a: float, b: float):
    """One layout epoch given its draws: ``active [m]`` (the Bernoulli edge
    gates) and ``negs [m, neg_rate]`` (the negatives). Per-edge gradients
    reduce into per-point updates by two sorted ``segment_reduce`` sums;
    no float atomics."""

    a, b, c_att, c_rep, b_m1 = _consts(a, b)
    yh = Y[ed.heads]
    d = yh - Y[ed.tails]
    d2 = (d * d).sum(dim=1, keepdim=True)
    g_att = _attraction(d2, a, b, c_att, b_m1)
    g_att = torch.where(active[:, None], g_att, torch.zeros_like(g_att))
    grad_h = torch.clamp(g_att * d, -4.0, 4.0)

    dn = yh[:, None, :] - Y[negs]
    dn2 = (dn * dn).sum(dim=2, keepdim=True)
    g_rep = _repulsion(dn2, a, b, c_rep)
    # inactive edges and self-negatives push nothing (umap-learn skips both)
    skip = (~active[:, None]) | (negs == ed.heads[:, None])
    g_rep = torch.where(skip[..., None], torch.zeros_like(g_rep), g_rep)
    head_grad = grad_h + torch.clamp(g_rep * dn, -4.0, 4.0).sum(dim=1)

    upd = torch.segment_reduce(head_grad, "sum", lengths=ed.len_h, axis=0, unsafe=True)
    upd = upd + torch.segment_reduce(-grad_h[ed.tperm], "sum", lengths=ed.len_t, axis=0,
                                     unsafe=True)  # move_other
    return Y + alpha * upd


def _optimize_layout(Y, ed: _Edges, gen: torch.Generator, *, n_epochs: int, neg_rate: int,
                     a: float, b: float, lr: float):
    """``n_epochs`` of :func:`_layout_epoch`, each epoch's gates
    (``uniform < weights``) and negatives drawn from ``gen``."""

    m = ed.heads.shape[0]
    for e in range(n_epochs):
        active = torch.rand(m, generator=gen, device=Y.device) < ed.weights
        negs = torch.randint(0, ed.n, (m, neg_rate), generator=gen, device=Y.device)
        Y = _layout_epoch(Y, ed, active, negs, _alpha(lr, e, n_epochs), a, b)
    return Y


def _edges_of(S, n: int, device) -> _Edges:
    """The layout's edges from the symmetric fuzzy graph: entries above
    1e-8, row sorted, weights normalized to max 1."""

    S = S.tocoo()
    keep = S.data > 1e-8
    w = S.data[keep]
    return _Edges(S.row[keep].astype(np.int64), S.col[keep].astype(np.int64),
                  (w / w.max()).astype(np.float32), n, device)


def _pca_init(X: torch.Tensor, n_components: int) -> torch.Tensor:
    """``Y0``: the centered rows projected on the top right singular
    vectors of the first 4,096 centered rows, each vector's
    largest-magnitude entry made positive, scaled to std 10."""

    Xc = X - X.mean(dim=0, keepdim=True)
    _, _, vt = torch.linalg.svd(Xc[: min(X.shape[0], 4096)], full_matrices=False)
    vt = vt[:n_components]
    lead = vt.gather(1, vt.abs().argmax(dim=1, keepdim=True))
    vt = vt * torch.where(lead < 0, -1.0, 1.0)
    Y0 = Xc @ vt.T
    return Y0 / (Y0.std(correction=0) + 1e-9) * 10.0


class UMAPConfig:
    """Configuration holder mirroring the builder-style configs of the
    reference (cf. ``TSNEConfig``)."""

    def __init__(
        self,
        n_components: int = 2,
        n_neighbors: int = 15,
        min_dist: float = 0.1,
        spread: float = 1.0,
        n_epochs: int = 200,
        learning_rate: float = 1.0,
        negative_sample_rate: int = 5,
        random_seed: int = 42,
        metric: str = "euclidean",
    ):
        if metric not in ("euclidean", "cosine"):
            raise ValueError(f"unknown metric {metric!r}; expected 'euclidean' or 'cosine'")
        self.n_components = n_components
        self.n_neighbors = n_neighbors
        self.min_dist = min_dist
        self.spread = spread
        self.n_epochs = n_epochs
        self.learning_rate = learning_rate
        self.negative_sample_rate = negative_sample_rate
        self.random_seed = random_seed
        self.metric = metric


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


class UMAP:
    """UMAP over dense embeddings (typically PCA scores).

    ``fit_transform(X)`` with X ``[n, d]`` (numpy or a tensor) returns the
    ``[n, n_components]`` embedding as a tensor on ``device`` (a tensor
    input keeps its own device)."""

    def __init__(self, config: Optional[UMAPConfig] = None, *, device="cuda", **kw):
        self.config = config or UMAPConfig(**kw)
        self.device = torch.device(device)
        self.embedding_: Optional[torch.Tensor] = None
        self.graph_: Optional[_Edges] = None
        self._train_X: Optional[torch.Tensor] = None

    @classmethod
    def from_state(cls, embedding, train_X, config: Optional[UMAPConfig] = None,
                   device="cuda") -> "UMAP":
        """A fitted model from an embedding and its training rows computed
        elsewhere (e.g. a JAX ``UMAP``'s ``embedding_`` and ``_train_X``):
        ``transform`` places new points against them."""

        m = cls(config, device=device)
        m.embedding_ = torch.as_tensor(np.array(embedding, np.float32), device=device)
        m._train_X = torch.as_tensor(np.array(train_X, np.float32), device=device)
        return m

    def _as_input(self, X) -> torch.Tensor:
        if not isinstance(X, torch.Tensor):
            X = torch.as_tensor(np.asarray(X), device=self.device)
        return X.float()

    @precision_policy()
    def fit_transform(self, X) -> torch.Tensor:
        cfg = self.config
        X = self._as_input(X)
        n = X.shape[0]
        k = min(cfg.n_neighbors, n - 1)
        if k < 1:
            raise ValueError("need at least 2 samples")
        S = fuzzy_connectivities(X, k, block=min(2048, max(8, n)), metric=cfg.metric)
        ed = _edges_of(S, n, X.device)
        self.graph_ = ed
        self._train_X = X
        a, b = _fit_ab(cfg.spread, cfg.min_dist)

        Y0 = _pca_init(X, cfg.n_components)
        gen = _generator(X.device, cfg.random_seed)
        if Y0.shape[1] < cfg.n_components:
            # fewer input dims than n_components: noise fills the rest
            pad = torch.randn((n, cfg.n_components - Y0.shape[1]), generator=gen,
                              device=X.device)
            Y0 = torch.cat([Y0, pad], dim=1)
        Y0 = Y0 + 0.1 * torch.randn(Y0.shape, generator=gen, device=X.device)
        self.embedding_ = _optimize_layout(
            Y0.float(), ed, _generator(X.device, cfg.random_seed + 1),
            n_epochs=cfg.n_epochs, neg_rate=cfg.negative_sample_rate, a=a, b=b,
            lr=cfg.learning_rate,
        )
        return self.embedding_

    @precision_policy()
    def transform(self, X_new, *, epochs: int = 30) -> torch.Tensor:
        """Embed new points into the fitted space (umap-learn
        ``transform``): each starts at the membership-weighted mean of its
        training neighbors' embeddings, then moves one-sidedly (training
        embedding frozen) for ``epochs``."""

        if self.embedding_ is None:
            raise RuntimeError("Must be fitted before transform!")
        cfg = self.config
        train = self._train_X
        Xn = self._as_input(X_new).to(train.device)
        if Xn.ndim != 2 or Xn.shape[1] != train.shape[1]:
            raise ValueError(f"X_new must be [m, {train.shape[1]}], got {tuple(Xn.shape)}")
        k = min(cfg.n_neighbors, train.shape[0])

        from ..neighbors import cross_knn

        d, idx = cross_knn(Xn, train, k, metric=cfg.metric)
        W = _memberships(d)
        Wn = W / torch.clamp(W.sum(dim=1, keepdim=True), min=1e-12)
        Ytrain = self.embedding_.float().to(train.device)
        idx = idx.long()
        Y0 = torch.einsum("mk,mkd->md", Wn, Ytrain[idx])
        a, b = _fit_ab(cfg.spread, cfg.min_dist)
        return _transform_layout(
            Y0, Ytrain, idx, W / W.max(), _generator(train.device, cfg.random_seed + 2),
            epochs=epochs, neg_rate=cfg.negative_sample_rate, a=a, b=b, lr=cfg.learning_rate,
        )
