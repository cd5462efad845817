"""k-nearest neighbors over dense embeddings: exact, over a mesh, and IVF.

Counterpart of ``single_algebra_tpu/neighbors.py``. Exact kNN is blocked
``[block, n_ref]`` squared-distance tiles ``|x|^2 - 2 x.y + |y|^2`` (one
GEMM each) and ``topk``; ``mesh=`` splits the query rows into the mesh's
row slabs, each scanned on its device against a replica of X (no
reduction). ``ivf_knn`` is the approximate index for n >> 200k;
``connectivities`` is scanpy's ``pp.neighbors`` graph; ``bbknn`` the
batch-balanced graph. Inputs go to ``device`` (the card by default)
unless they are tensors already.

Among equal distances the order of the ids is torch's, which may differ
from ``lax.top_k``'s.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .models.umap import (
    _knn_graph,
    _metric_prep,
    _smooth_knn,
    _to_cosine_dist,
    fuzzy_connectivities,
)
from .types import precision_policy

__all__ = ["knn", "connectivities", "cross_knn", "ivf_knn", "bbknn"]


def _as_tensor(X, device) -> torch.Tensor:
    if not isinstance(X, torch.Tensor):
        X = torch.as_tensor(np.asarray(X), device=device)
    return X.float()


def _cross_knn(Q: torch.Tensor, R: torch.Tensor, *, k: int, block: int, approx: bool = False):
    """kNN of each query row among the REFERENCE rows, ``[block, n_ref]``
    tiles: ``(dists [nq, k], idx [nq, k] int64)``, nearest first.

    ``approx=True`` is the JAX package's ``lax.approx_max_k`` request (the
    TPU's approximate top-k, recall target 0.95, for large k). Torch has
    no approximate top-k: the exact ``topk`` serves it, which meets that
    contract with recall 1."""

    del approx  # the exact selection meets the approximate contract
    r2 = (R * R).sum(dim=1)
    nq = Q.shape[0]
    d = torch.empty((nq, k), dtype=torch.float32, device=Q.device)
    i = torch.empty((nq, k), dtype=torch.int64, device=Q.device)
    for r0 in range(0, nq, block):
        qb = Q[r0:r0 + block]
        d2 = (qb * qb).sum(dim=1)[:, None] - 2.0 * (qb @ R.T) + r2[None, :]
        nd, ni = torch.topk(-d2, k, dim=1)
        d[r0:r0 + block] = torch.sqrt(torch.clamp(-nd, min=0.0))
        i[r0:r0 + block] = ni
    return d, i


def _mesh_blocks(n: int, mesh, block: int) -> dict:
    """The JAX package's slab geometry: ``rs`` rows per slab, a multiple of
    the query block ``blk``."""

    rs = max(-(-n // mesh.size), 8)
    blk = min(block, max(rs // 8 // 8 * 8, 8))
    return dict(block=blk, rs=-(-rs // blk) * blk, n=n)


def _knn_graph_mesh(X: torch.Tensor, *, k: int, block: int, rs: int, n: int, mesh,
                    axis_name: str = "rows"):
    """Mesh-sharded exact kNN: slab ``d`` (rows ``[d * rs, (d + 1) * rs)``)
    scans its ``[block, n]`` tiles on ``mesh.devices[d]`` against a
    replica of X; the slabs' results are gathered on the home device in
    slab order. Blocks past the last real row are skipped (the JAX
    package computes them and drops them)."""

    from .parallel.sharded import _replicas

    del axis_name  # one-axis mesh
    X = X.float()
    reps = _replicas(X, mesh)
    sqs = {dev: (x * x).sum(dim=1) for dev, x in reps.items()}
    d_parts, i_parts = [], []
    for s, dev in enumerate(mesh.devices):
        Xf, sq = reps[dev], sqs[dev]
        for off in range(s * rs, min((s + 1) * rs, n), block):
            xb = Xf[off:off + block]
            d2 = (xb * xb).sum(dim=1)[:, None] + sq[None, :] - 2.0 * (xb @ Xf.T)
            torch.diagonal(d2, offset=off).fill_(float("inf"))
            nd, ni = torch.topk(-d2, k, dim=1)
            d_parts.append((-nd).to(mesh.home))
            i_parts.append(ni.int().to(mesh.home))
    d = torch.cat(d_parts)[:n]
    return torch.sqrt(torch.clamp(d, min=0.0)), torch.cat(i_parts)[:n]


@precision_policy()
def knn(
    X, k: int, *, block: int = 2048, return_distances: bool = True,
    metric: str = "euclidean", mesh=None, device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor] | torch.Tensor:
    """k nearest neighbors of every row of ``X`` (self excluded):
    ``(distances [n, k], indices [n, k])`` ascending (indices only with
    ``return_distances=False``). ``metric``: 'euclidean' or 'cosine'
    (distances ``1 - cos``). ``mesh``: the scan over its row slabs, the
    results on its home device."""

    if mesh is not None:
        device = mesh.home
    X = _metric_prep(_as_tensor(X, device), metric)
    n = X.shape[0]
    if k < 1 or k > n - 1:
        raise ValueError(f"k={k} must be in [1, n-1] (n={n})")
    if mesh is not None:
        d, idx = _knn_graph_mesh(X, k=k, mesh=mesh, **_mesh_blocks(n, mesh, block))
    else:
        d, idx = _knn_graph(X, k=k, block=min(block, max(8, n)))
    if metric == "cosine":
        d = _to_cosine_dist(d)
    return (d, idx) if return_distances else idx


@precision_policy()
def cross_knn(X_query, X_ref, k: int, *, block: int = 2048,
              metric: str = "euclidean", approx: bool = False, device="cuda"):
    """k nearest REFERENCE rows for every query row (exact, cross-set):
    ``(distances [nq, k], indices [nq, k])`` ascending. ``approx`` is
    accepted for the JAX signature; see :func:`_cross_knn`."""

    Xq = _metric_prep(_as_tensor(X_query, device), metric)
    Xr = _metric_prep(_as_tensor(X_ref, Xq.device), metric).to(Xq.device)
    if Xq.ndim != 2 or Xr.ndim != 2 or Xq.shape[1] != Xr.shape[1]:
        raise ValueError(f"query {tuple(Xq.shape)} and reference {tuple(Xr.shape)} must be "
                         "2-d with equal feature counts")
    if not (1 <= k <= Xr.shape[0]):
        raise ValueError(f"k={k} must be in [1, n_ref={Xr.shape[0]}]")
    d, idx = _cross_knn(Xq, Xr, k=k, block=min(block, max(8, Xq.shape[0])), approx=approx)
    if metric == "cosine":
        d = _to_cosine_dist(d)
    return d, idx


@precision_policy()
def connectivities(
    X, n_neighbors: int = 15, *, block: int = 2048, method: str = "auto",
    metric: str = "euclidean", mesh=None, device="cuda",
):
    """Symmetric fuzzy kNN graph of an embedding, as scipy CSR ``[n, n]``
    (scanpy's ``pp.neighbors`` connectivities; feed it to
    ``cluster.leiden``). ``method='auto'`` uses the exact blocked kNN and
    the IVF index above 200,000 rows."""

    if mesh is not None:
        device = mesh.home
    X = _as_tensor(X, device)
    n = X.shape[0]
    k = min(n_neighbors, n - 1)
    if k < 1:
        raise ValueError("need at least 2 samples")
    return fuzzy_connectivities(X, k, block=min(block, max(8, n)), method=method,
                                metric=metric, mesh=mesh)


# ----------------------------------------------------------------------
# IVF
# ----------------------------------------------------------------------

# (query, probe) pairs per search chunk: bounds the [pairs, k] candidates
_IVF_PAIRS = 1 << 24
# elements of one [queries, members] distance tile of a list
_IVF_TILE = 1 << 28


def _ivf_plan(n: int, n_lists=None, n_probe=None) -> Tuple[int, int]:
    """The JAX package's defaults: ``L ~ sqrt(n)`` lists (at least 8),
    ``n_probe = max(16, L // 8)``, both at most L (L at most n)."""

    L = min(n_lists or max(8, int(np.sqrt(n))), n)
    return L, min(n_probe or max(16, L // 8), L)


def _ivf_centroids(X: torch.Tensor, L: int, seed: int) -> torch.Tensor:
    """KMeans (15 Lloyd steps) over a numpy ``default_rng(seed)`` sample of
    ``50 L`` rows: the JAX package's sample, the port's k-means++ draws."""

    from .models.kmeans import KMeans

    n = X.shape[0]
    rng = np.random.default_rng(seed)
    rows = torch.as_tensor(rng.choice(n, min(n, 50 * L), replace=False), device=X.device)
    km = KMeans(n_clusters=L, n_init=1, max_iter=15, random_seed=seed, device=X.device)
    return km.fit(X[rows]).cluster_centers_


class _IvfIndex:
    """The inverted lists of X under the centroids ``cent``: every row
    assigned to its nearest centroid, rows sorted by list (``Xs``, their
    ids ``ids``, their squared norms ``v2``) with host list bounds
    ``starts``. The JAX package pads every list to the fullest one
    (``[L, cap, d]``); here each list is a contiguous span of ``Xs``, so
    the store is ``n x d`` whatever ``cap`` is."""

    def __init__(self, X: torch.Tensor, cent: torch.Tensor):
        from .models.kmeans import _assign

        self.X = X
        self.cent = cent.to(X.device).float()
        assign = _assign(X, (X * X).sum(dim=1), self.cent).long()
        order = torch.argsort(assign, stable=True)
        counts = torch.bincount(assign, minlength=self.cent.shape[0]).cpu().numpy()
        self.starts = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=self.starts[1:])
        self.cap = int(counts.max())
        self.ids = order
        self.Xs = X[order]
        self.v2 = (self.Xs * self.Xs).sum(dim=1)

    @property
    def n_lists(self) -> int:
        return self.cent.shape[0]

    def search(self, Q: torch.Tensor, q_ids: torch.Tensor, *, k: int, n_probe: int):
        """Each query scans its ``n_probe`` nearest lists: ``(dists [nq, k],
        ids [nq, k])``, nearest first; ``q_ids`` (-1: none) excludes a
        query's own row. A query whose probed lists hold fewer than k
        candidates gets ``-1`` ids (and inf distances) in the missing slots.

        The JAX package scans probes per query block; here the (query,
        probe) pairs of a chunk are grouped by list, and each list's
        members meet its queries in GEMM tiles of at most ``_IVF_TILE``
        elements, whose top-k per query goes into the pair's candidate
        row. A query's k best over
        its candidate rows are the JAX package's neighbors, ties aside."""

        nq = Q.shape[0]
        L, dev = self.n_lists, Q.device
        c2 = (self.cent * self.cent).sum(dim=1)
        q2 = (Q * Q).sum(dim=1)
        D = torch.empty((nq, k), dtype=torch.float32, device=dev)
        I = torch.empty((nq, k), dtype=torch.int64, device=dev)
        chunk = max(1, _IVF_PAIRS // n_probe)
        for q0 in range(0, nq, chunk):
            Qc, q2c, qid = Q[q0:q0 + chunk], q2[q0:q0 + chunk], q_ids[q0:q0 + chunk]
            B = Qc.shape[0]
            dc = q2c[:, None] - 2.0 * (Qc @ self.cent.T) + c2[None, :]
            probes = torch.topk(dc, n_probe, dim=1, largest=False).indices.reshape(-1)
            del dc
            pairs = torch.argsort(probes, stable=True)
            per_list = torch.bincount(probes, minlength=L).cpu().numpy()
            cand_d = torch.full((B * n_probe, k), float("inf"), device=dev)
            cand_i = torch.full((B * n_probe, k), -1, dtype=torch.int64, device=dev)
            pos = 0
            for lst in np.nonzero(per_list)[0]:
                s, e = self.starts[lst], self.starts[lst + 1]
                ids = self.ids[s:e]
                kk = min(k, int(e - s))
                step = max(1, _IVF_TILE // max(int(e - s), 1))
                for p0 in range(pos, pos + per_list[lst], step):
                    if e == s:
                        break
                    sel = pairs[p0:min(p0 + step, pos + per_list[lst])]
                    qi = torch.div(sel, n_probe, rounding_mode="floor")
                    d2 = (q2c[qi][:, None] - 2.0 * (Qc[qi] @ self.Xs[s:e].T)
                          + self.v2[s:e][None, :])
                    d2.masked_fill_(ids[None, :] == qid[qi][:, None], float("inf"))
                    nd, ni = torch.topk(d2, kk, dim=1, largest=False)
                    cand_d[sel, :kk] = nd
                    cand_i[sel, :kk] = ids[ni].masked_fill_(torch.isinf(nd), -1)
                pos += per_list[lst]
            nd, ni = torch.topk(cand_d.view(B, n_probe * k), k, dim=1, largest=False)
            D[q0:q0 + B] = nd
            I[q0:q0 + B] = cand_i.view(B, n_probe * k).gather(1, ni)
        return torch.sqrt(torch.clamp(D, min=0.0)), I


def _ivf_query(index: _IvfIndex, query, k: int, n_probe: int, block: int):
    """Search ``query`` (None: X itself, self excluded) and resolve the
    rows that came back with fewer than k neighbors exactly, by
    ``cross_knn`` against X (the JAX package's sentinel branch)."""

    X = index.X
    n = X.shape[0]
    if query is None:
        Q = X
        q_ids = torch.arange(n, device=X.device)
    else:
        Q = _as_tensor(query, X.device).to(X.device)
        if Q.ndim != 2 or Q.shape[1] != X.shape[1]:
            raise ValueError(f"query must be [nq, {X.shape[1]}], got {tuple(Q.shape)}")
        q_ids = torch.full((Q.shape[0],), -1, dtype=torch.int64, device=X.device)
    D, I = index.search(Q, q_ids, k=k, n_probe=n_probe)
    bad = torch.nonzero((I < 0).any(dim=1)).flatten()
    if len(bad):
        kk = k + 1 if query is None else k
        db, ib = cross_knn(Q[bad], X, min(kk, n), block=block)
        if query is None:  # drop the self-hit, keep the first k others
            first = torch.argsort((ib == bad[:, None]).to(torch.int8), dim=1, stable=True)[:, :k]
            ib, db = ib.gather(1, first), db.gather(1, first)
        I[bad], D[bad] = ib[:, :k], db[:, :k]
    return D, I


@precision_policy()
def ivf_knn(
    X,
    k: int,
    *,
    query=None,
    n_lists: int | None = None,
    n_probe: int | None = None,
    block: int = 512,
    seed: int = 0,
    device="cuda",
):
    """Approximate kNN via an IVF (inverted-file) index, the scaling path
    when exact ``knn``'s O(n^2 d) dominates (n >> 200k).

    Build: KMeans centroids over a sample, every row assigned to its
    nearest centroid. Search: each query scans its ``n_probe`` nearest
    lists (:meth:`_IvfIndex.search`). ``query=None`` searches X against
    itself with self-exclusion. Defaults: ``n_lists ~ sqrt(n)``,
    ``n_probe = max(16, n_lists // 8)``. ``block`` is the query block of
    the exact resolution of short rows. Returns ``(distances [nq, k],
    indices [nq, k])`` ascending."""

    X = _as_tensor(X, device)
    n = X.shape[0]
    if not (1 <= k <= n - (query is None)):
        raise ValueError(f"k={k} out of range for n={n}")
    L, npr = _ivf_plan(n, n_lists, n_probe)
    index = _IvfIndex(X, _ivf_centroids(X, L, seed))
    return _ivf_query(index, query, k, npr, block)


@precision_policy()
def bbknn(
    X,
    batch,
    *,
    neighbors_within_batch: int = 3,
    trim: int | None = None,
    block: int = 2048,
    device="cuda",
):
    """Batch-balanced kNN graph (Polanski et al. 2020; scanpy
    ``external.pp.bbknn``): every cell takes its
    ``neighbors_within_batch`` nearest neighbors from EACH batch, weights
    calibrated by smooth kNN per batch, fuzzy union as in
    :func:`connectivities`. ``trim`` keeps each cell's strongest
    connectivities. Returns a symmetric scipy CSR."""

    import scipy.sparse as sp

    X = _as_tensor(X, device)
    n = X.shape[0]
    batch = np.asarray(list(batch))
    if batch.shape[0] != n:
        raise ValueError(f"batch length ({batch.shape[0]}) != rows ({n})")
    labels = list(dict.fromkeys(batch.tolist()))
    if neighbors_within_batch < 1:
        raise ValueError("neighbors_within_batch must be >= 1")
    kb = neighbors_within_batch

    W_parts, idx_parts = [], []
    for b in labels:
        ref_rows = np.where(batch == b)[0]
        kk = min(kb, len(ref_rows))
        if kk < 1:
            continue
        ref = torch.as_tensor(ref_rows, device=X.device)
        d, idx_b = cross_knn(X, X[ref], kk + 1, block=block)
        d = d.cpu().numpy().astype(np.float32)
        idx_b = ref_rows[idx_b.cpu().numpy()]
        self_hit = idx_b == np.arange(n)[:, None]
        d = np.where(self_hit, np.inf, d)
        order = np.argsort(d, axis=1)[:, :kk]
        d = np.take_along_axis(d, order, axis=1)
        idx_b = np.take_along_axis(idx_b, order, axis=1)
        fin = np.isfinite(d)
        d = np.where(fin, d, 0.0).astype(np.float32)
        dt = torch.as_tensor(d, device=X.device)
        rho, sigma = _smooth_knn(dt)
        Wb = torch.exp(-torch.clamp(dt - rho[:, None], min=0.0) / sigma[:, None])
        W_parts.append(np.where(fin, Wb.cpu().numpy().astype(np.float64), 0.0))
        idx_parts.append(idx_b)
    W = np.concatenate(W_parts, axis=1)
    idx = np.concatenate(idx_parts, axis=1)
    k_tot = W.shape[1]
    A = sp.coo_matrix(
        (W.ravel(), (np.repeat(np.arange(n, dtype=np.int64), k_tot),
                     idx.ravel().astype(np.int64))),
        shape=(n, n),
    ).tocsr()
    A.eliminate_zeros()
    S = A + A.T - A.multiply(A.T)
    if trim is not None:
        S = S.tolil()
        for i in range(n):
            row = np.asarray(S.data[i])
            if len(row) > trim:
                cutoff = np.partition(row, -trim)[-trim]
                keep = row >= cutoff
                S.rows[i] = [c for c, kf in zip(S.rows[i], keep) if kf]
                S.data[i] = [v for v, kf in zip(S.data[i], keep) if kf]
        S = S.tocsr()
        S = S.maximum(S.T)
    return S.tocsr()
