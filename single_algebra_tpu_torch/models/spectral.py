"""Spectral clustering over the operator seam.

Counterpart of ``single_algebra_tpu/models/spectral.py``
(Ng-Jordan-Weiss normalized cuts):

1. the exact kNN graph of the input rows (``neighbors.knn``),
2. the symmetric affinity ``W = (A + A^T) / 2`` as a ``SparseMatrix``,
3. the top-k eigenvectors of ``M = D^{-1/2} W D^{-1/2}`` by
   :func:`block_lanczos_svd` on the PSD shift ``I + M`` (its singular
   vectors are its eigenvectors; each Krylov step is one sparse product
   and two diagonal scalings). Block Lanczos resolves the tight
   multiplets under the top of an affinity spectrum in tens of steps,
4. the row-normalized embedding clustered by :class:`KMeans`.

The start block of the Krylov space and the k-means++ seeds are drawn
from ``torch.Generator``s seeded with ``random_seed``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..linalg import block_lanczos as _bl
from ..sparse.matrix import SparseMatrix
from ..types import precision_policy
from .kmeans import KMeans

__all__ = ["SpectralClustering", "SpectralClusteringBuilder"]


@dataclasses.dataclass
class _ShiftedNormalizedAffinity:
    """``(I + D^{-1/2} W D^{-1/2}) v`` products: symmetric and PSD, so
    ``mv`` is ``rmv``; one sparse product and two diagonal scalings."""

    w: SparseMatrix  # [n, n]
    s: torch.Tensor  # D^{-1/2} [n], on w's device

    @property
    def shape(self):
        return self.w.shape

    @property
    def dtype(self):
        return self.s.dtype

    @property
    def device(self):
        return self.s.device

    def mv(self, V):
        return V + self.s[:, None] * self.w.matmul_dense(self.s[:, None] * V)

    rmv = mv


def _inv_sqrt(deg: np.ndarray, device) -> torch.Tensor:
    """``D^{-1/2}`` of float64 degrees (0 for isolated nodes) as float32."""

    s = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-30)), 0.0)
    return torch.as_tensor(s, dtype=torch.float32, device=device)


class SpectralClustering:
    """Normalized-cut clustering of dense rows (e.g. PCA embeddings).

    ``fit(X)`` / ``fit_predict(X)`` set ``labels_``, ``affinity_matrix_``
    (the ``SparseMatrix`` W, on ``device``) and ``maps_`` (the [n, k]
    spectral embedding, host float32). Transductive: no ``predict``.
    """

    def __init__(
        self,
        n_clusters: int = 8,
        *,
        n_neighbors: int = 15,
        n_init: int = 3,
        random_seed: int = 42,
        lanczos_steps: Optional[int] = None,
        lanczos_block: Optional[int] = None,
        device="cuda",
    ):
        if n_clusters < 2:
            raise ValueError(f"n_clusters={n_clusters} must be >= 2")
        if n_neighbors < 1:
            raise ValueError(f"n_neighbors={n_neighbors} must be >= 1")
        self.n_clusters = n_clusters
        self.n_neighbors = n_neighbors
        self.n_init = n_init
        self.random_seed = random_seed
        # Krylov depth / block width of the eigensolve
        self.lanczos_steps = lanczos_steps
        self.lanczos_block = lanczos_block
        self.device = device
        self.labels_: Optional[np.ndarray] = None
        self.maps_: Optional[np.ndarray] = None
        self.affinity_matrix_: Optional[SparseMatrix] = None

    def _affinity(self, X: torch.Tensor) -> SparseMatrix:
        import scipy.sparse as sp

        from ..neighbors import knn

        n = X.shape[0]
        idx = knn(X, self.n_neighbors, return_distances=False).cpu().numpy()
        rows = np.repeat(np.arange(n, dtype=np.int64), self.n_neighbors)
        A = sp.csr_matrix((np.ones(rows.size, np.float32), (rows, idx.ravel().astype(np.int64))),
                          shape=(n, n))
        W = (A + A.T) * 0.5  # sklearn 'nearest_neighbors' symmetrization
        return SparseMatrix.from_scipy(W.tocsr(), device=X.device)

    @precision_policy()
    def fit(self, X) -> "SpectralClustering":
        if isinstance(X, torch.Tensor):
            X = X.float()
        else:
            X = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        if X.ndim != 2:
            raise ValueError(f"Expected a 2-d array, got shape {tuple(X.shape)}")
        n = X.shape[0]
        if self.n_clusters > n:
            raise ValueError(f"n_clusters={self.n_clusters} exceeds n_samples={n}")
        if self.n_neighbors > n - 1:
            raise ValueError(f"n_neighbors={self.n_neighbors} must be <= n-1 ({n - 1})")
        w = self._affinity(X)
        deg = w.sum_row().cpu().numpy().astype(np.float64)
        op = _ShiftedNormalizedAffinity(w, _inv_sqrt(deg, X.device))
        b = self.lanczos_block or min(self.n_clusters + 2, n)
        # Krylov dimension: enough blocks to surround the top-k multiplet
        kdim = self.lanczos_steps or max(96, 16 * self.n_clusters)
        res = _bl.block_lanczos_svd(op, self.n_clusters, block_size=b,
                                    steps=max(2, -(-kdim // b)), seed=self.random_seed)
        U = res.u.cpu().numpy()  # [n, k] top eigenvectors of I + M
        # Ng-Jordan-Weiss: row-normalize the embedding before KMeans
        maps = U / np.maximum(np.linalg.norm(U, axis=1, keepdims=True), 1e-12)
        km = KMeans(self.n_clusters, n_init=self.n_init, random_seed=self.random_seed,
                    device=X.device).fit(torch.as_tensor(maps.astype(np.float32), device=X.device))
        self.labels_ = km.labels_.cpu().numpy()
        self.maps_ = maps
        self.affinity_matrix_ = w
        return self

    def fit_predict(self, X) -> np.ndarray:
        return self.fit(X).labels_


@dataclasses.dataclass
class SpectralClusteringBuilder:
    """Fluent builder, matching the library's builder style."""

    _n_clusters: int = 8
    _n_neighbors: int = 15
    _n_init: int = 3
    _random_seed: int = 42
    _lanczos_steps: Optional[int] = None
    _lanczos_block: Optional[int] = None
    _device: object = "cuda"

    def n_clusters(self, k: int) -> "SpectralClusteringBuilder":
        self._n_clusters = k
        return self

    def n_neighbors(self, k: int) -> "SpectralClusteringBuilder":
        self._n_neighbors = k
        return self

    def n_init(self, n: int) -> "SpectralClusteringBuilder":
        self._n_init = n
        return self

    def random_seed(self, s: int) -> "SpectralClusteringBuilder":
        self._random_seed = s
        return self

    def lanczos_steps(self, n: int) -> "SpectralClusteringBuilder":
        self._lanczos_steps = n
        return self

    def lanczos_block(self, b: int) -> "SpectralClusteringBuilder":
        self._lanczos_block = b
        return self

    def device(self, d) -> "SpectralClusteringBuilder":
        self._device = d
        return self

    def build(self) -> SpectralClustering:
        return SpectralClustering(
            self._n_clusters,
            n_neighbors=self._n_neighbors,
            n_init=self._n_init,
            random_seed=self._random_seed,
            lanczos_steps=self._lanczos_steps,
            lanczos_block=self._lanczos_block,
            device=self._device,
        )
