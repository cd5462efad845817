"""KMeans clustering: Lloyd's algorithm with k-means++ init, by GEMMs.

Counterpart of ``single_algebra_tpu/models/kmeans.py``. Every O(n) pass is
a matrix product on the input's device:

- assignment: ``d2 = |x|^2 + |c|^2 - 2 X C^T`` (one ``[n, d] x [d, k]``
  GEMM, or the port's ELL product for a ``SparseMatrix``), argmin over k;
- update: ``C = H^T X / counts`` with ``H`` the one-hot assignment;
- k-means++ init: D^2 sampling, one matvec per center, categorical draws
  (``torch.multinomial``) from a ``torch.Generator`` seeded with
  ``random_seed + trial``;
- Lloyd: a host loop on (centroid shift^2 > tol) & (it < max_iter); empty
  clusters are re-seeded with the points farthest from their centers.

The JAX package draws its k-means++ seeds from ``jax.random``, which torch
cannot reproduce: the init (:func:`_plusplus_init`) and Lloyd
(:func:`_lloyd`, from given centers) are separate functions, so a JAX
fit's init can be fed to the port's Lloyd. ``tol`` is scaled by the mean
per-feature variance (sklearn's ``_tolerance``); ``inertia_`` is the
summed squared distance at the final assignment.

``mesh`` (a ``parallel.Mesh``, dense inputs only) shards the rows: slab
``d`` of ``ceil(n / size)`` rows lives on ``mesh.devices[d]``, each Lloyd
step computes its slab's distances, labels and partial sums there, and the
centers' sums and counts are added on the home device in slab order (the
JAX mesh's one ``psum``). The init runs on the home device over all rows,
as the single-card fit's does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..sparse.matrix import SparseMatrix
from ..types import precision_policy

__all__ = ["KMeans", "KMeansBuilder"]


def _is_sparse(X) -> bool:
    return isinstance(X, SparseMatrix)


def _xdot(X, C_t: torch.Tensor) -> torch.Tensor:
    """``X @ C_t`` ([n, k], float32) for dense or sparse X."""

    if _is_sparse(X):
        return X.matmul_dense(C_t.to(X.dtype)).float()
    return X @ C_t


def _xtdot(X, H: torch.Tensor) -> torch.Tensor:
    """``X.T @ H`` ([d, k], float32) for dense or sparse X."""

    if _is_sparse(X):
        return X.rmatmul_dense(H.to(X.dtype)).float()
    return X.T @ H


def _row_sq_norms(X) -> torch.Tensor:
    if _is_sparse(X):
        return X.sum_row_squared().float()
    return (X * X).sum(dim=1)


def _n_of(X) -> int:
    return X.nrows if _is_sparse(X) else X.shape[0]


def _d_of(X) -> int:
    return X.ncols if _is_sparse(X) else X.shape[1]


def _gather_rows(X, idx: torch.Tensor) -> torch.Tensor:
    """``X[idx]`` as dense float32 ``[len(idx), d]``; for sparse X by an
    indicator product."""

    if _is_sparse(X):
        n = _n_of(X)
        H = (idx[None, :] == torch.arange(n, device=idx.device)[:, None]).float()
        return _xtdot(X, H).T
    return X[idx]


def _pairwise_d2(x2: torch.Tensor, X, C: torch.Tensor) -> torch.Tensor:
    """Squared distances ``[n, k]``; the cross term is one product."""

    c2 = (C * C).sum(dim=1)
    return x2[:, None] + c2[None, :] - 2.0 * _xdot(X, C.T)


def _plusplus_init(gen: torch.Generator, X, x2: torch.Tensor, w: torch.Tensor,
                   k: int) -> torch.Tensor:
    """k-means++ D^2 sampling (Arthur & Vassilvitskii 2007) on X's device.
    ``w`` is a {0, 1} row-validity mask: zero-weight rows are never
    drawn. The draws are ``torch.multinomial`` over ``gen``; the weights
    are the JAX package's logits ``log(max(d2, 1e-30))`` exponentiated."""

    valid = w > 0
    first = torch.multinomial(valid.float(), 1, generator=gen)
    C = torch.zeros((k, _d_of(X)), dtype=torch.float32, device=x2.device)
    C[0] = _gather_rows(X, first)[0]
    c0 = C[0]
    min_d2 = torch.clamp(x2 - 2.0 * _xdot(X, c0[:, None])[:, 0] + (c0 * c0).sum(), min=0.0)
    for i in range(1, k):
        probs = torch.where(valid, torch.clamp(min_d2, min=1e-30), torch.zeros_like(min_d2))
        idx = torch.multinomial(probs, 1, generator=gen)
        c = _gather_rows(X, idx)[0]
        C[i] = c
        d2 = torch.clamp(x2 - 2.0 * _xdot(X, c[:, None])[:, 0] + (c * c).sum(), min=0.0)
        min_d2 = torch.minimum(min_d2, d2)
    return C


def _one_hot(labels: torch.Tensor, k: int, w: torch.Tensor) -> torch.Tensor:
    return (labels[:, None] == torch.arange(k, device=labels.device)[None, :]) * w[:, None]


def _lloyd(X, x2, tol2: float, C0: torch.Tensor, w: torch.Tensor, *, k: int,
           max_iter: int):
    """Lloyd from the centers ``C0`` to convergence (the JAX package's
    ``_fit_one`` after its init). Returns ``(centers [k, d], labels [n]
    int32, inertia float, n_iter)``."""

    C = C0
    shift2, it = float("inf"), 0
    while shift2 > tol2 and it < max_iter:
        d2 = _pairwise_d2(x2, X, C)
        labels = torch.argmin(d2, dim=1)
        H = _one_hot(labels, k, w)
        counts = H.sum(dim=0)
        new_C = _xtdot(X, H).T / torch.clamp(counts, min=1.0)[:, None]
        empty = counts == 0
        if bool(empty.any()):
            # the farthest points from their centers take over empty clusters
            point_d2 = d2.gather(1, labels[:, None])[:, 0] * w
            far = torch.topk(point_d2, k).indices
            new_C = torch.where(empty[:, None], _gather_rows(X, far), new_C)
        shift2 = float(((new_C - C) ** 2).sum())
        C, it = new_C, it + 1
    d2 = _pairwise_d2(x2, X, C)
    labels = torch.argmin(d2, dim=1)
    inertia = float((torch.clamp(d2.gather(1, labels[:, None]), min=0.0) * w[:, None]).sum())
    return C, labels.int(), inertia, it


def _lloyd_mesh(mesh, X: torch.Tensor, x2, tol2: float, C0: torch.Tensor, *, k: int,
                max_iter: int):
    """:func:`_lloyd` over row slabs of ``mesh`` (dense X): each slab's
    distances, labels, partial sums and counts on its device, the sums
    added on the home device in slab order."""

    from ..parallel.sharded import _psum, _replicas

    home, n = mesh.home, X.shape[0]
    rs = -(-n // mesh.size)
    slabs = [(X[d * rs:(d + 1) * rs].to(dev), x2[d * rs:(d + 1) * rs].to(dev))
             for d, dev in enumerate(mesh.devices)]

    def slab_terms(C):
        reps = _replicas(C, mesh)
        for (Xs, x2s), dev in zip(slabs, mesh.devices):
            d2 = _pairwise_d2(x2s, Xs, reps[dev])
            labels = torch.argmin(d2, dim=1)
            yield Xs, d2, labels

    C = C0
    shift2, it = float("inf"), 0
    while shift2 > tol2 and it < max_iter:
        parts, point_d2 = [], []
        for (Xs, d2, labels) in slab_terms(C):
            H = _one_hot(labels, k, torch.ones(labels.shape[0], device=labels.device))
            parts.append(torch.cat([(Xs.T @ H).T, H.sum(dim=0)[:, None]], dim=1))
            point_d2.append(d2.gather(1, labels[:, None])[:, 0])
        tot = _psum(parts, home)
        counts = tot[:, -1]
        new_C = tot[:, :-1] / torch.clamp(counts, min=1.0)[:, None]
        empty = counts == 0
        if bool(empty.any()):
            # each slab's k farthest points, then the k farthest of those
            tops = [torch.topk(pd, min(k, pd.shape[0])) for pd in point_d2]
            vals = torch.cat([t.values.to(home) for t in tops])
            rows = torch.cat([Xs[t.indices].to(home) for (Xs, _), t in zip(slabs, tops)])
            new_C = torch.where(empty[:, None], rows[torch.topk(vals, k).indices], new_C)
        shift2 = float(((new_C - C) ** 2).sum())
        C, it = new_C, it + 1
    labels, inertia = [], []
    for (_, d2, lab) in slab_terms(C):
        labels.append(lab.int().to(home))
        inertia.append(torch.clamp(d2.gather(1, lab[:, None]), min=0.0).sum())
    return C, torch.cat(labels), float(_psum(inertia, home)), it


def _assign(X, x2, C) -> torch.Tensor:
    return torch.argmin(_pairwise_d2(x2, X, C), dim=1).int()


def _minibatch_step(X, x2, C, counts, *, k: int):
    """One MiniBatchKMeans update (Sculley 2010 / sklearn): assign the
    batch, move each center toward its batch mean with learning rate
    1/total_count."""

    d2 = _pairwise_d2(x2, X, C)
    labels = torch.argmin(d2, dim=1)
    H = _one_hot(labels, k, torch.ones(labels.shape[0], device=labels.device))
    batch_counts = H.sum(dim=0)
    batch_sums = _xtdot(X, H).T
    new_counts = counts + batch_counts
    C = C + (batch_sums - batch_counts[:, None] * C) / torch.clamp(new_counts, min=1.0)[:, None]
    inertia = float(torch.clamp(d2.gather(1, labels[:, None]), min=0.0).sum())
    return C, new_counts, labels.int(), inertia


def _prep(X, device):
    """A SparseMatrix stays itself; a dense input becomes a float32 tensor
    on ``device`` (a tensor stays on its own device)."""

    if _is_sparse(X):
        return X
    if not isinstance(X, torch.Tensor):
        X = torch.as_tensor(np.asarray(X), device=device)
    if X.ndim != 2:
        raise ValueError(f"Expected a 2-d array, got shape {tuple(X.shape)}")
    return X.float()


class KMeans:
    """Lloyd's algorithm with k-means++ init, on the card by default.

    Parameters mirror sklearn: ``n_clusters``, ``max_iter``, ``tol``
    (scaled by the mean feature variance), ``n_init`` restarts keeping the
    lowest inertia, seeded by ``random_seed``. ``device`` is where dense
    numpy inputs and the centers go (the mesh's home device with
    ``mesh``)."""

    def __init__(
        self,
        n_clusters: int = 8,
        *,
        max_iter: int = 300,
        tol: float = 1e-4,
        n_init: int = 1,
        random_seed: int = 42,
        verbose: bool = False,
        mesh=None,
        device="cuda",
    ):
        if n_clusters < 1:
            raise ValueError(f"n_clusters={n_clusters} must be >= 1")
        if n_init < 1:
            raise ValueError(f"n_init={n_init} must be >= 1")
        self.n_clusters = n_clusters
        self.max_iter = max_iter
        self.tol = tol
        self.n_init = n_init
        self.random_seed = random_seed
        self.verbose = verbose
        self.mesh = mesh
        self.device = torch.device(mesh.home if mesh is not None else device)
        self.cluster_centers_: Optional[torch.Tensor] = None
        self.labels_: Optional[torch.Tensor] = None
        self.inertia_: Optional[float] = None
        self.n_iter_: Optional[int] = None
        self._counts: Optional[torch.Tensor] = None  # minibatch state

    @classmethod
    def from_state(cls, centers, *, n_iter: int = 0, inertia: float = float("nan"),
                   device="cuda", **kwargs) -> "KMeans":
        """A fitted model from centers computed elsewhere (e.g. a JAX
        ``KMeans``'s ``cluster_centers_``): ``predict`` / ``transform`` /
        ``partial_fit`` continue from them."""

        C = torch.as_tensor(np.array(centers, np.float32), device=device)
        m = cls(C.shape[0], device=device, **kwargs)
        m.cluster_centers_, m.n_iter_, m.inertia_ = C, int(n_iter), float(inertia)
        return m

    def _tol2(self, X) -> float:
        """sklearn's ``_tolerance``: tol x mean per-feature variance."""

        if _is_sparse(X):
            mv = X.var_col().float().mean()
        else:
            mv = X.var(dim=0, correction=0).mean()
        return float((self.tol * mv).float())

    @precision_policy()
    def fit(self, X) -> "KMeans":
        X = _prep(X, self.device)
        n = _n_of(X)
        if self.n_clusters > n:
            raise ValueError(f"n_clusters={self.n_clusters} exceeds n_samples={n}")
        if self.mesh is not None and _is_sparse(X):
            raise ValueError(
                "mesh mode supports dense inputs; shard sparse matrices "
                "via the parallel.sharded engines and cluster embeddings"
            )
        if self.mesh is not None:
            X = X.to(self.mesh.home)
        dev = X.device
        x2 = _row_sq_norms(X)
        tol2 = self._tol2(X)
        w = torch.ones(n, dtype=torch.float32, device=dev)
        best = None
        for trial in range(self.n_init):
            gen = torch.Generator(device=dev)
            gen.manual_seed(self.random_seed + trial)
            C0 = _plusplus_init(gen, X, x2, w, self.n_clusters)
            if self.mesh is not None:
                out = _lloyd_mesh(self.mesh, X, x2, tol2, C0, k=self.n_clusters,
                                  max_iter=self.max_iter)
            else:
                out = _lloyd(X, x2, tol2, C0, w, k=self.n_clusters, max_iter=self.max_iter)
            if self.verbose:
                print(f"KMeans init {trial}: inertia={out[2]:.6g} iters={out[3]}")
            if best is None or out[2] < best[2]:
                best = out
        self.cluster_centers_, self.labels_, self.inertia_, self.n_iter_ = best
        return self

    @precision_policy()
    def partial_fit(self, X) -> "KMeans":
        """Minibatch update from one row batch (sklearn
        ``MiniBatchKMeans.partial_fit``): the first call k-means++-seeds
        the centers from the batch (>= n_clusters rows), each call moves
        the centers toward the batch means with per-center 1/count
        learning rates. ``labels_`` / ``inertia_`` are the last batch's."""

        if self.mesh is not None:
            raise ValueError("partial_fit is single-device; mesh mode applies to fit()")
        X = _prep(X, self.device)
        x2 = _row_sq_norms(X)
        if self.cluster_centers_ is None:
            n = _n_of(X)
            if self.n_clusters > n:
                raise ValueError(f"first batch has {n} rows < n_clusters={self.n_clusters}")
            gen = torch.Generator(device=X.device)
            gen.manual_seed(self.random_seed)
            w = torch.ones(n, dtype=torch.float32, device=X.device)
            self.cluster_centers_ = _plusplus_init(gen, X, x2, w, self.n_clusters)
            self._counts = torch.zeros(self.n_clusters, dtype=torch.float32,
                                       device=X.device)
            self.n_iter_ = 0
        elif _d_of(X) != self.cluster_centers_.shape[1]:
            raise ValueError(f"X has {_d_of(X)} features; fitted centers have "
                             f"{self.cluster_centers_.shape[1]}")
        if self._counts is None:
            self._counts = torch.zeros(self.n_clusters, dtype=torch.float32,
                                       device=self.cluster_centers_.device)
        C, counts, labels, inertia = _minibatch_step(
            X, x2, self.cluster_centers_, self._counts, k=self.n_clusters)
        self.cluster_centers_, self._counts = C, counts
        self.labels_, self.inertia_ = labels, inertia
        self.n_iter_ = int(self.n_iter_) + 1
        return self

    @precision_policy()
    def predict(self, X) -> torch.Tensor:
        self._check_fitted()
        X = _prep(X, self.device)
        if _d_of(X) != self.cluster_centers_.shape[1]:
            raise ValueError(f"X has {_d_of(X)} features; fitted centers have "
                             f"{self.cluster_centers_.shape[1]}")
        return _assign(X, _row_sq_norms(X), self.cluster_centers_.to(X.device))

    def fit_predict(self, X) -> torch.Tensor:
        return self.fit(X).labels_

    @precision_policy()
    def transform(self, X) -> torch.Tensor:
        """Distances ``[n, k]`` to the fitted centers."""

        self._check_fitted()
        X = _prep(X, self.device)
        d2 = _pairwise_d2(_row_sq_norms(X), X, self.cluster_centers_.to(X.device))
        return torch.sqrt(torch.clamp(d2, min=0.0))

    def fit_transform(self, X) -> torch.Tensor:
        return self.fit(X).transform(X)

    def score(self, X) -> float:
        """Negative inertia of X under the fitted centers (sklearn)."""

        d = self.transform(X)
        return -float((d.min(dim=1).values ** 2).sum())

    def _check_fitted(self):
        if self.cluster_centers_ is None:
            raise ValueError("KMeans has not been fitted yet")

    def save(self, path: str) -> None:
        """The JAX package's ``.npz`` format: either package loads it."""

        self._check_fitted()
        counts = (self._counts.cpu().numpy() if self._counts is not None
                  else np.zeros((self.n_clusters,), np.float32))
        np.savez(
            path,
            cluster_centers=self.cluster_centers_.cpu().numpy(),
            inertia=np.float64(self.inertia_),
            n_iter=np.int64(self.n_iter_),
            n_clusters=np.int64(self.n_clusters),
            counts=counts,
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "KMeans":
        if not path.endswith(".npz"):
            path = path + ".npz"
        with np.load(path) as z:
            m = cls.from_state(z["cluster_centers"], n_iter=int(z["n_iter"]),
                               inertia=float(z["inertia"]), device=device)
            if "counts" in z:
                m._counts = torch.as_tensor(z["counts"], device=device)
        return m


@dataclasses.dataclass
class KMeansBuilder:
    """Fluent builder, matching the library's PCA builder style."""

    _n_clusters: int = 8
    _max_iter: int = 300
    _tol: float = 1e-4
    _n_init: int = 1
    _random_seed: int = 42
    _verbose: bool = False
    _mesh: object = None
    _device: object = "cuda"

    def n_clusters(self, k: int) -> "KMeansBuilder":
        self._n_clusters = k
        return self

    def max_iter(self, n: int) -> "KMeansBuilder":
        self._max_iter = n
        return self

    def tol(self, t: float) -> "KMeansBuilder":
        self._tol = t
        return self

    def n_init(self, n: int) -> "KMeansBuilder":
        self._n_init = n
        return self

    def random_seed(self, s: int) -> "KMeansBuilder":
        self._random_seed = s
        return self

    def verbose(self, v: bool) -> "KMeansBuilder":
        self._verbose = v
        return self

    def mesh(self, m) -> "KMeansBuilder":
        self._mesh = m
        return self

    def device(self, d) -> "KMeansBuilder":
        self._device = d
        return self

    def build(self) -> KMeans:
        return KMeans(
            self._n_clusters,
            max_iter=self._max_iter,
            tol=self._tol,
            n_init=self._n_init,
            random_seed=self._random_seed,
            verbose=self._verbose,
            mesh=self._mesh,
            device=self._device,
        )
