"""Clustering, embedding and integration quality metrics.

Counterpart of ``single_algebra_tpu/metrics.py``:

- ``silhouette_samples`` / ``silhouette_score``: exact, on the device.
  Per row block, one ``[block, n]`` Euclidean-distance tile (the
  ``|x|^2 + |y|^2 - 2 x y^T`` GEMM) times the ``[n, k]`` one-hot label
  matrix gives every point's per-cluster distance sums; no ``[n, n]``
  array. ``mesh=`` scans the row slabs of a ``parallel.Mesh``, each on
  its device against a replica of X, the slabs' values gathered on the
  home device in slab order.
- ``adjusted_rand_index`` / ``normalized_mutual_info``: host contingency
  arithmetic.
- ``morans_i`` / ``gearys_c``: one graph product per value block.
- ``embedding_density``: the same distance tiles, a Gaussian kernel.
- ``lisi``, ``silhouette_batch``, ``kbet``: the integration metrics over
  the exact kNN and the t-SNE perplexity calibration.

Inputs go to ``device`` (the card unless the caller names another)
unless they are tensors already.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import precision_policy

__all__ = [
    "silhouette_score",
    "silhouette_samples",
    "silhouette_batch",
    "adjusted_rand_index",
    "normalized_mutual_info",
    "morans_i",
    "gearys_c",
    "embedding_density",
    "lisi",
    "kbet",
]


def _as_f32(X, device) -> torch.Tensor:
    if not isinstance(X, torch.Tensor):
        X = torch.as_tensor(np.asarray(X, np.float32), device=device)
    return X.float()


def _silhouette_rows(xb, lb, X, x2, H, counts) -> torch.Tensor:
    """s(i) = (b - a) / max(a, b) for the rows ``xb`` (labels ``lb``):
    a(i) the mean distance to the own cluster without the point itself (0
    for a singleton, where s(i) = 0 as in sklearn), b(i) the least mean
    distance to another cluster."""

    k = H.shape[1]
    d2 = torch.clamp((xb * xb).sum(dim=1)[:, None] + x2[None, :] - 2.0 * (xb @ X.T), min=0.0)
    S = torch.sqrt(d2) @ H  # [block, k] per-cluster distance sums
    own = S.gather(1, lb[:, None])[:, 0]
    own_count = counts[lb]
    a = own / torch.clamp(own_count - 1.0, min=1.0)
    mean_other = S / torch.clamp(counts, min=1.0)[None, :]
    kk = torch.arange(k, device=X.device)
    mean_other = torch.where((kk[None, :] == lb[:, None]) | (counts[None, :] == 0),
                             torch.full_like(mean_other, float("inf")), mean_other)
    b = mean_other.amin(dim=1)
    s = (b - a) / torch.clamp(torch.maximum(a, b), min=1e-30)
    return torch.where(own_count > 1.0, s, torch.zeros_like(s))


def _silhouette_device(X, labels, counts, *, k: int, block: int) -> torch.Tensor:
    x2 = (X * X).sum(dim=1)
    H = (labels[:, None] == torch.arange(k, device=X.device)[None, :]).float()
    n = X.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=X.device)
    for r0 in range(0, n, block):
        out[r0:r0 + block] = _silhouette_rows(X[r0:r0 + block], labels[r0:r0 + block],
                                              X, x2, H, counts)
    return out


def _silhouette_mesh(X, labels, counts, *, k: int, block: int, rs: int, n: int, mesh,
                     axis_name: str = "rows") -> torch.Tensor:
    """Slab ``d`` (rows ``[d * rs, (d + 1) * rs)``) scans its ``[block, n]``
    tiles on ``mesh.devices[d]`` against replicas of X, labels and counts
    (no reduction); the per-point values come back to the home device in
    slab order. Blocks past the last real row are skipped (the JAX package
    computes them and drops them)."""

    from .parallel.sharded import _replicas

    del axis_name  # one-axis mesh
    reps = {dev: (x, (x * x).sum(dim=1), labels.to(dev), counts.to(dev))
            for dev, x in _replicas(X, mesh).items()}
    parts = []
    for s, dev in enumerate(mesh.devices):
        Xf, x2, lab, cnt = reps[dev]
        H = (lab[:, None] == torch.arange(k, device=dev)[None, :]).float()
        for off in range(s * rs, min((s + 1) * rs, n), block):
            parts.append(_silhouette_rows(Xf[off:off + block], lab[off:off + block],
                                          Xf, x2, H, cnt).to(mesh.home))
    return torch.cat(parts)[:n]


@precision_policy()
def silhouette_samples(X, labels, *, block: int = 2048, mesh=None,
                       device="cuda") -> torch.Tensor:
    """Per-point silhouette coefficients (exact, on the device).
    ``mesh`` shards the O(n^2) distance scan over its row slabs."""

    if mesh is not None:
        device = mesh.home
    X = _as_f32(X, device)
    labels_np = np.asarray(labels.cpu() if isinstance(labels, torch.Tensor) else labels)
    uniq, inv = np.unique(labels_np, return_inverse=True)
    k = len(uniq)
    if k < 2:
        raise ValueError("silhouette requires at least 2 clusters")
    if k >= X.shape[0]:
        raise ValueError("silhouette requires n_samples > n_clusters")
    n = X.shape[0]
    counts = torch.as_tensor(np.bincount(inv, minlength=k).astype(np.float32), device=X.device)
    lab = torch.as_tensor(inv.astype(np.int64), device=X.device)
    if mesh is not None:
        from .neighbors import _mesh_blocks

        return _silhouette_mesh(X, lab, counts, k=k, mesh=mesh, **_mesh_blocks(n, mesh, block))
    return _silhouette_device(X, lab, counts, k=k, block=min(block, max(8, n)))


def silhouette_score(X, labels, *, block: int = 2048, device="cuda") -> float:
    """Mean silhouette coefficient over all samples (sklearn parity)."""

    return float(silhouette_samples(X, labels, block=block, device=device).mean())


def _contingency(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    C = np.zeros((len(ua), len(ub)), np.int64)
    np.add.at(C, (ia, ib), 1)
    return C


def _labels_np(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x).ravel()


def adjusted_rand_index(labels_true, labels_pred) -> float:
    """Adjusted Rand index (Hubert & Arabie 1985); 1 = identical
    partitions, ~0 = random agreement."""

    a, b = _labels_np(labels_true), _labels_np(labels_pred)
    if a.shape != b.shape:
        raise ValueError("label arrays must have the same length")
    C = _contingency(a, b)
    n = C.sum()

    def comb2(x):
        return x * (x - 1) / 2.0

    sum_ij = comb2(C.astype(np.float64)).sum()
    sum_a = comb2(C.sum(axis=1).astype(np.float64)).sum()
    sum_b = comb2(C.sum(axis=0).astype(np.float64)).sum()
    expected = sum_a * sum_b / comb2(float(n))
    max_index = (sum_a + sum_b) / 2.0
    if max_index == expected:
        return 1.0
    return float((sum_ij - expected) / (max_index - expected))


def normalized_mutual_info(labels_true, labels_pred) -> float:
    """NMI with arithmetic-mean normalization (sklearn default)."""

    a, b = _labels_np(labels_true), _labels_np(labels_pred)
    if a.shape != b.shape:
        raise ValueError("label arrays must have the same length")
    C = _contingency(a, b).astype(np.float64)
    pij = C / C.sum()
    pa = pij.sum(axis=1, keepdims=True)
    pb = pij.sum(axis=0, keepdims=True)
    nz = pij > 0
    mi = float((pij[nz] * np.log(pij[nz] / (pa @ pb)[nz])).sum())

    def ent(p):
        p = p[p > 0]
        return float(-(p * np.log(p)).sum())

    ha, hb = ent(pa.ravel()), ent(pb.ravel())
    if ha == 0.0 and hb == 0.0:
        return 1.0
    denom = (ha + hb) / 2.0
    return mi / denom if denom > 0 else 0.0


# ---------------------------------------------------------------------------
# graph autocorrelation (scanpy sc.metrics.morans_i / gearys_c)
# ---------------------------------------------------------------------------


def _graph_autocorr(graph, X, *, block: int, device):
    """Per-value (num_moran, num_geary, denom): for a centered value block
    Xb, one graph product ``W @ Xb``; Moran's numerator is
    colsum(Xb * W Xb), Geary's 2 (x^T D x - x^T W x) with D the degrees."""

    import scipy.sparse as sp

    from .sparse.matrix import SparseMatrix

    if isinstance(graph, SparseMatrix):
        W, Wsp = graph, graph.to_scipy()
    else:
        Wsp = sp.csr_matrix(graph)
        W = SparseMatrix.from_scipy(Wsp.astype(np.float32), device=device)
    n = W.shape[0]
    if W.shape[0] != W.shape[1]:
        raise ValueError(f"graph must be square, got {W.shape}")
    X = np.asarray(X.cpu() if isinstance(X, torch.Tensor) else X, np.float32)
    if X.ndim == 1:
        X = X[:, None]
    if X.shape[0] != n:
        raise ValueError(f"values rows ({X.shape[0]}) != graph nodes ({n})")
    w_sum = float(Wsp.sum())
    deg = np.asarray(Wsp.sum(axis=1)).ravel().astype(np.float64)

    p = X.shape[1]
    num_m, num_g, den = np.empty(p), np.empty(p), np.empty(p)
    for j0 in range(0, p, block):
        xb = X[:, j0:j0 + block]
        xc = xb - xb.mean(axis=0, keepdims=True)
        wx = W.matmul_dense(torch.from_numpy(xc)).cpu().numpy().astype(np.float64)
        xc = xc.astype(np.float64)
        num_m[j0:j0 + block] = (xc * wx).sum(axis=0)
        xdx = (xc * xc * deg[:, None]).sum(axis=0)
        num_g[j0:j0 + block] = 2.0 * (xdx - (xc * wx).sum(axis=0))
        den[j0:j0 + block] = (xc * xc).sum(axis=0)
    return n, w_sum, num_m, num_g, np.maximum(den, 1e-30)


def morans_i(graph, values, *, block: int = 512, device="cuda") -> np.ndarray:
    """Moran's I of per-cell values over a (kNN) graph (scanpy
    ``sc.metrics.morans_i``): +1 = neighbors agree, ~0 = random.
    ``values`` [n] or [n, p]; one device product per value block. A
    ``SparseMatrix`` graph keeps its device."""

    n, w_sum, num_m, _, den = _graph_autocorr(graph, values, block=block, device=device)
    out = (n / w_sum) * num_m / den
    return out[0] if np.ndim(values) == 1 else out


def gearys_c(graph, values, *, block: int = 512, device="cuda") -> np.ndarray:
    """Geary's C (scanpy ``sc.metrics.gearys_c``): 0 = perfect positive
    autocorrelation, 1 = none, 2 = anti."""

    n, w_sum, _, num_g, den = _graph_autocorr(graph, values, block=block, device=device)
    out = ((n - 1.0) / (2.0 * w_sum)) * num_g / den
    return out[0] if np.ndim(values) == 1 else out


@precision_policy()
def embedding_density(Y, *, groups=None, block: int = 2048, device="cuda") -> np.ndarray:
    """Per-cell Gaussian KDE in a low-dim embedding (scanpy
    ``tl.embedding_density``) within each group, min-max scaled to [0, 1]
    per group; Scott's-rule bandwidth per group. The kernel sums run over
    ``[block, m]`` distance tiles on the device."""

    if isinstance(Y, torch.Tensor):
        device = Y.device
    Y = np.asarray(Y.cpu() if isinstance(Y, torch.Tensor) else Y, np.float32)
    if Y.ndim != 2:
        raise ValueError(f"expected [n, d] embedding, got {Y.shape}")
    n, d = Y.shape
    groups = np.zeros(n, np.int32) if groups is None else np.asarray(groups)
    if groups.shape[0] != n:
        raise ValueError(f"groups length ({groups.shape[0]}) != rows ({n})")
    out = np.zeros(n)
    for g in np.unique(groups):
        sel = np.where(groups == g)[0]
        m = len(sel)
        if m < 2:
            out[sel] = 0.0
            continue
        Yg = torch.as_tensor(Y[sel], device=device)
        h = float(m ** (-1.0 / (d + 4)) * np.std(Y[sel])) or 1.0
        y2 = (Yg * Yg).sum(dim=1)
        dens = torch.empty(m, dtype=torch.float32, device=device)
        for i0 in range(0, m, block):
            blk = Yg[i0:i0 + block]
            d2 = (blk * blk).sum(dim=1)[:, None] - 2.0 * (blk @ Yg.T) + y2[None, :]
            dens[i0:i0 + block] = torch.exp(-torch.clamp(d2, min=0.0) / (2.0 * h * h)).mean(dim=1)
        dens = dens.cpu().numpy().astype(np.float64)
        lo, hi = dens.min(), dens.max()
        out[sel] = (dens - lo) / (hi - lo) if hi > lo else 0.5
    return out


# ----------------------------------------------------------------------
# integration-quality metrics (the scib surface)
# ----------------------------------------------------------------------

# elements of one [rows, k, labels] one-hot block
_ONEHOT_BLOCK = 1 << 24


def _label_mass(p: torch.Tensor, codes: torch.Tensor, n_labels: int) -> torch.Tensor:
    """``q[i, l] = sum_j p[i, j] [codes[i, j] == l]`` -> ``[n, L]``: the
    JAX package's one-hot product, in row blocks (a fixed summation order:
    no atomics)."""

    n, k = p.shape
    lab = torch.arange(n_labels, device=p.device)
    out = torch.empty((n, n_labels), dtype=p.dtype, device=p.device)
    step = max(1, _ONEHOT_BLOCK // max(k * n_labels, 1))
    for r0 in range(0, n, step):
        onehot = (codes[r0:r0 + step, :, None] == lab[None, None, :]).to(p.dtype)
        out[r0:r0 + step] = (p[r0:r0 + step, :, None] * onehot).sum(dim=1)
    return out


def _lisi_device(d2, codes, perplexity, n_labels: int) -> torch.Tensor:
    """Per-cell inverse Simpson's index over the perplexity-calibrated
    Gaussian neighborhood (rows of ``d2 [n, k]`` ascending, self excluded;
    ``codes [n, k]`` the neighbors' label codes)."""

    from .models.tsne import _calibrate_p_knn

    q = _label_mass(_calibrate_p_knn(d2, perplexity), codes, n_labels)
    return 1.0 / torch.clamp((q * q).sum(dim=1), min=1e-12)


@precision_policy()
def lisi(X, labels, *, perplexity: float = 30.0, block: int = 2048,
         device="cuda") -> np.ndarray:
    """Local Inverse Simpson's Index per cell (Korsunsky et al. 2019).
    ``lisi(emb, batch)`` (iLISI): ~1 when each neighborhood is one batch,
    ~n_batches when batches mix; ``lisi(emb, cell_type)`` (cLISI): lower
    is better. kNN at k = 3 * perplexity, then the t-SNE calibration."""

    from .neighbors import knn

    X = _as_f32(X, device)
    n = X.shape[0]
    labels = _labels_np(labels)
    if labels.shape[0] != n:
        raise ValueError(f"labels length ({labels.shape[0]}) != rows ({n})")
    uniq, inv = np.unique(labels, return_inverse=True)
    if len(uniq) < 1 or n < 4:
        raise ValueError("lisi needs n >= 4 and at least one label")
    k = int(min(n - 1, max(round(3 * perplexity), 3)))
    if k < perplexity:
        raise ValueError(f"perplexity={perplexity} too large for n={n} (k={k})")
    d, idx = knn(X, k, block=block)
    codes = torch.as_tensor(inv.astype(np.int64), device=X.device)[idx.long()]
    out = _lisi_device(d.float() ** 2, codes, float(perplexity), len(uniq))
    return out.cpu().numpy()


def silhouette_batch(X, batch, group, *, block: int = 2048, device="cuda") -> float:
    """Batch-mixing silhouette (scib ``silhouette_batch``): within each
    cell-type ``group``, the mean of ``1 - |s|`` of the BATCH silhouette;
    groups holding a single batch are skipped."""

    if isinstance(X, torch.Tensor):
        device = X.device
    X = np.asarray(X.cpu() if isinstance(X, torch.Tensor) else X, np.float32)
    batch, group = _labels_np(batch), _labels_np(group)
    if not (X.shape[0] == batch.shape[0] == group.shape[0]):
        raise ValueError(
            f"rows ({X.shape[0]}), batch ({batch.shape[0]}) and group "
            f"({group.shape[0]}) lengths must match"
        )
    scores = []
    for g in np.unique(group):
        sel = group == g
        bs = batch[sel]
        if len(np.unique(bs)) < 2 or sel.sum() <= len(np.unique(bs)):
            continue
        s = silhouette_samples(X[sel], bs, block=block, device=device).cpu().numpy()
        scores.append(float(np.mean(1.0 - np.abs(s))))
    if not scores:
        raise ValueError("no group contains more than one batch — nothing to score")
    return float(np.mean(scores))


@precision_policy()
def kbet(X, batch, *, k: int = 25, alpha: float = 0.05, block: int = 2048,
         device="cuda") -> float:
    """kBET acceptance rate (Büttner et al. 2019, simplified): the
    fraction of cells whose k-neighborhood batch composition passes a
    chi-squared test against the global batch frequencies (p > alpha)."""

    from scipy.stats import chi2

    from .neighbors import knn

    X = _as_f32(X, device)
    n = X.shape[0]
    batch = _labels_np(batch)
    if batch.shape[0] != n:
        raise ValueError(f"batch length ({batch.shape[0]}) != rows ({n})")
    uniq, inv = np.unique(batch, return_inverse=True)
    B = len(uniq)
    if B < 2:
        raise ValueError("kbet needs at least 2 batches")
    k = int(min(k, n - 1))
    idx = knn(X, k, block=block, return_distances=False)
    codes = torch.as_tensor(inv.astype(np.int64), device=X.device)[idx.long()]
    counts = _label_mass(torch.ones(codes.shape, dtype=torch.float32, device=X.device),
                         codes, B)
    expected = np.bincount(inv, minlength=B).astype(np.float64) / n * k
    e32 = torch.as_tensor(expected, dtype=torch.float32, device=X.device)
    safe = torch.as_tensor(np.maximum(expected, 1e-12), dtype=torch.float32, device=X.device)
    stat = (((counts - e32) ** 2) / safe).sum(dim=1).cpu().numpy().astype(np.float64)
    return float(np.mean(chi2.sf(stat, df=B - 1) > alpha))
