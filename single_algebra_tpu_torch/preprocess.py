"""Post-normalization preprocessing: normalize_total, TF-IDF, Pearson
residuals, aggregates, ``scale``, ``regress_out``, ComBat and sampling.

Counterpart of ``single_algebra_tpu/preprocess.py`` (scanpy's ``pp``
surface). Column moments come from the matrix's device reductions, a dense
result is one scatter densify of the row ELL (``ops.spmm.
ell_scatter_densify``) on the matrix's device, ``regress_out``'s projector
is two GEMMs and a q x q solve, ComBat's empirical-Bayes fit is host numpy
over p-length moments. Dense inputs (numpy or torch) go to ``device``
unless they are tensors already; the sampling utilities draw from numpy's
``default_rng``, so their draws are the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops.spmm import ell_scatter_densify
from .qc import _host
from .sparse.matrix import SparseMatrix
from .types import precision_policy

__all__ = [
    "normalize_total",
    "normalize_pearson_residuals",
    "tfidf",
    "scale",
    "regress_out",
    "combat",
    "subsample",
    "downsample_counts",
    "aggregate",
]


def _is_sparse(X) -> bool:
    return isinstance(X, SparseMatrix)


def _dense_rows(m) -> torch.Tensor:
    """The matrix as a dense ``[n, p]`` tensor on its device: one scatter
    of the row-major ELL."""

    mr = m._layout_for("row")
    return ell_scatter_densify(mr.ell_data, mr.ell_ids, mr.row_nnz, m.ncols)[: m.nrows]


def _as_dense(X, device) -> torch.Tensor:
    return X if isinstance(X, torch.Tensor) else torch.as_tensor(np.asarray(X), device=device)


def _take(fac: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(fac, ids, mode="clip")``: padded slots carry ids past the
    end (the column layout's row iota), clipped like the JAX gather."""

    return fac[ids.long().clamp(0, fac.shape[0] - 1)]


@precision_policy()
def normalize_total(
    m,
    *,
    target_sum: Optional[float] = None,
    exclude_highly_expressed: bool = False,
    max_fraction: float = 0.05,
):
    """Total-count normalize rows (scanpy ``pp.normalize_total``).

    ``target_sum=None`` uses the median of the positive per-cell counts.
    ``exclude_highly_expressed`` recomputes each cell's size factor
    without genes that take more than ``max_fraction`` of any cell's
    counts (the genes stay in the matrix). Returns ``(normalized_matrix,
    size_factors)``."""

    from .types import Direction

    sums = _host(m.sum_row(), np.float64)
    if exclude_highly_expressed:
        shares = m.normalize(np.where(sums > 0, sums, 1.0), 1.0, Direction.ROW)
        _, col_max = shares.min_max_col()
        keep = col_max.cpu().numpy() <= max_fraction
        sums = _host(m.sum_row_masked(keep), np.float64)
    if target_sum is None:
        pos = sums[sums > 0]
        target_sum = float(np.median(pos)) if pos.size else 1.0
    out = m.normalize(sums, target_sum, Direction.ROW)
    return out, sums / target_sum


def _tfidf_fn(v, r, c, row_fac, col_fac, sf, log_tf, log_tfidf):
    """Stored-entry TF-IDF map: the 1/rowsum TF factor gathers by row id,
    the IDF factor by column id; every branch maps 0 -> 0."""

    tf = v * _take(row_fac, r)
    tf = torch.where(log_tf, torch.log1p(tf * sf), tf)
    out = tf * _take(col_fac, c)
    return torch.where(log_tfidf, torch.log1p(out * sf), out)


def _scale_cols_fn(v, r, c, inv_std):
    return v * _take(inv_std, c)


def _scale_cols_clip_fn(v, r, c, inv_std, maxv):
    return torch.minimum(v * _take(inv_std, c), maxv)


@precision_policy()
def tfidf(
    m,
    *,
    scale_factor: float = 1e4,
    log_tf: bool = True,
    log_idf: bool = True,
    log_tfidf: bool = False,
):
    """TF-IDF normalization of a cells x peaks count matrix (muon
    ``atac.pp.tfidf`` / Signac ``RunTFIDF``): TF = x / rowsum, IDF =
    n_cells / colsum; the defaults give ``log1p(TF * scale_factor) *
    log1p(IDF)``, ``log_tfidf=True`` (with the other logs off) gives
    ``log1p(TF * IDF * scale_factor)``. Zeros stay zeros, so the result
    is a SparseMatrix; zero-sum rows / columns get zero factors."""

    if log_tfidf and (log_tf or log_idf):
        raise ValueError(
            "log_tfidf cannot be combined with log_tf / log_idf "
            "(muon rule: pass log_tf=False, log_idf=False)"
        )
    n = m.nrows
    rs = _host(m.sum_row(), np.float64)
    cs = _host(m.sum_col(), np.float64)
    inv_rs = np.where(rs > 0, 1.0 / np.where(rs > 0, rs, 1.0), 0.0)
    idf = np.where(cs > 0, n / np.where(cs > 0, cs, 1.0), 0.0)
    if log_idf:
        idf = np.log1p(idf)
    dt = m.dtype
    return m.map_stored(
        _tfidf_fn,
        torch.as_tensor(inv_rs, dtype=dt),
        torch.as_tensor(idf, dtype=dt),
        torch.as_tensor(scale_factor, dtype=dt),
        torch.as_tensor(log_tf),
        torch.as_tensor(log_tfidf),
    )


def _pearson_residuals_dense(dense, t, g, theta, clip):
    total = t.sum()
    mu = torch.outer(t, g) / torch.where(total > 0, total, torch.ones_like(total))
    denom = torch.sqrt(mu + mu * mu / theta)
    ok = denom > 0
    r = torch.where(ok, (dense - mu) / torch.where(ok, denom, torch.ones_like(denom)),
                    torch.zeros_like(mu))
    return torch.clamp(r, -clip, clip)


@precision_policy()
def normalize_pearson_residuals(
    m,
    *,
    theta: float = 100.0,
    clip: Optional[float] = None,
):
    """Analytic Pearson residuals of raw counts (Lause, Berens & Kobak
    2021): mu = t_i g_g / total, r = (x - mu) / sqrt(mu + mu^2 / theta),
    clipped to ``[-clip, clip]`` (default ``sqrt(n)``). Returns a dense
    ``[n, p]`` tensor on the matrix's device; zero-total cells and genes
    get zero residuals."""

    if not theta > 0:
        raise ValueError(f"theta={theta} must be > 0")
    n = m.nrows
    if clip is None:
        clip = float(np.sqrt(n))
    if clip <= 0:
        raise ValueError(f"clip={clip} must be > 0 (scanpy: None -> sqrt(n))")
    dense = _dense_rows(m)
    dt = dense.dtype
    return _pearson_residuals_dense(
        dense, m.sum_row().to(dt), m.sum_col().to(dt),
        torch.as_tensor(theta, dtype=dt), torch.as_tensor(clip, dtype=dt),
    )


@precision_policy()
def aggregate(m, labels, *, funcs=("mean", "frac_nonzero")):
    """Per-group per-gene aggregates (scanpy ``sc.get.aggregate``): dict of
    ``[n_groups, p]`` float64 arrays keyed by func, plus ``groups``.
    Funcs: 'mean' and 'var' (Bessel) with zeros included, 'sum',
    'frac_nonzero', 'count_nonzero', all from the grouped one-hot
    products of the column layout."""

    n, p = m.shape
    names, codes = m._batch_codes(list(labels), n, "row")
    sizes = np.bincount(codes, minlength=len(names)).astype(np.float64)
    out = {"groups": np.asarray(names, object)}
    need_sum = {"mean", "sum", "var"} & set(funcs)
    sums = _host(m._batch_spmm("col", codes, "sum"), np.float64).T if need_sum else None
    for f in funcs:
        if f == "sum":
            out[f] = sums
        elif f == "mean":
            out[f] = sums / np.maximum(sizes, 1.0)[:, None]
        elif f == "var":
            sumsq = _host(m._batch_spmm("col", codes, "sumsq"), np.float64).T
            mean = sums / np.maximum(sizes, 1.0)[:, None]
            out[f] = np.maximum(
                (sumsq - sums * mean) / np.maximum(sizes - 1.0, 1.0)[:, None], 0.0)
        elif f in ("frac_nonzero", "count_nonzero"):
            cnt = _host(m._batch_spmm("col", codes, "count"), np.float64).T
            out[f] = cnt / np.maximum(sizes, 1.0)[:, None] if f == "frac_nonzero" else cnt
        else:
            raise ValueError(f"Unknown aggregate func {f!r}")
    return out


def _col_mean_std(X):
    """(mean, std, inv_std) per column, zeros included, Bessel; zero-var
    columns get std 1 (left unscaled, as scanpy does)."""

    if _is_sparse(X):
        n = X.nrows
        mean = X.sum_col() / n
        var = X.var_col()
    else:
        n = X.shape[0]
        mean = X.mean(dim=0)
        var = X.var(dim=0, correction=0) * (n / max(n - 1, 1))
    std = torch.sqrt(torch.clamp(var, min=0.0))
    safe = torch.where(std > 0, std, torch.ones_like(std))
    return mean, safe, 1.0 / safe


@precision_policy()
def scale(X, *, zero_center: bool = True, max_value: Optional[float] = None,
          device="cuda"):
    """Standardize genes (columns) to unit variance (scanpy ``pp.scale``).

    ``zero_center=True`` subtracts the column mean and returns a dense
    tensor ``[n, p]``; ``zero_center=False`` only multiplies by 1/std and
    keeps a SparseMatrix sparse. ``max_value`` clips values above it
    (upper clip only); zero-variance columns stay unscaled. A dense
    numpy input goes to ``device``."""

    if not _is_sparse(X):
        X = _as_dense(X, device)
    mean, _, inv_std = _col_mean_std(X)

    if _is_sparse(X):
        if not zero_center:
            if max_value is not None:
                return X.map_stored(_scale_cols_clip_fn, inv_std,
                                    torch.as_tensor(max_value, dtype=X.dtype))
            return X.map_stored(_scale_cols_fn, inv_std)
        dense = _dense_rows(X)
    else:
        dense = X
        if not zero_center:
            out = dense * inv_std[None, :]
            if max_value is not None:
                out = torch.clamp(out, max=max_value)
            return out

    out = (dense - mean[None, :]) * inv_std[None, :]
    if max_value is not None:
        out = torch.clamp(out, max=max_value)
    return out


def _residuals(dense: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """``dense`` minus its projection onto span(C) (C ``[n, q]``, q tiny):
    the Gram ``C^T C`` in C's float32, the rest in the promoted type."""

    dt = torch.promote_types(dense.dtype, C.dtype)
    G = (C.T @ C).to(dt)
    Cd = C.to(dt)
    B = torch.linalg.solve(G, Cd.T @ dense.to(dt))
    return dense.to(dt) - Cd @ B


@precision_policy()
def regress_out(X, covariates, *, add_intercept: bool = True, device="cuda"):
    """Per-gene OLS residuals against cell covariates (scanpy
    ``pp.regress_out``). ``covariates`` is ``[n]`` or ``[n, q]``, taken as
    float32 as in the JAX package; one projector ``B = (C^T C)^{-1} C^T X``
    serves every gene. Returns a dense ``[n, p]`` tensor."""

    if _is_sparse(X):
        dense = _dense_rows(X)
    else:
        dense = _as_dense(X, device)
    n = dense.shape[0]
    cov = torch.as_tensor(np.asarray(covariates.cpu() if isinstance(covariates, torch.Tensor)
                                     else covariates), dtype=torch.float32,
                          device=dense.device)
    if cov.ndim == 1:
        cov = cov[:, None]
    if cov.shape[0] != n:
        raise ValueError(f"covariates rows ({cov.shape[0]}) != matrix rows ({n})")
    if add_intercept:
        cov = torch.cat([torch.ones((n, 1), dtype=cov.dtype, device=cov.device), cov], dim=1)
    return _residuals(dense, cov)


# ----------------------------------------------------------------------
# ComBat batch correction
# ----------------------------------------------------------------------


def _combat_eb(zs, zss, n_b, max_iter: int = 100, tol: float = 1e-4):
    """Parametric empirical-Bayes shrinkage for one batch (vectors over
    genes); returns (gamma_star, delta_sq_star). Host numpy, as in the JAX
    package."""

    g_hat = zs / n_b
    d_hat = np.maximum((zss - n_b * g_hat * g_hat) / (n_b - 1.0), 1e-12)
    g_bar, t2 = g_hat.mean(), g_hat.var()
    m, s2 = d_hat.mean(), max(d_hat.var(), 1e-12)
    a_prior = (2.0 * s2 + m * m) / s2
    b_prior = (m * s2 + m ** 3) / s2

    g_star, d_star = g_hat.copy(), d_hat.copy()
    for _ in range(max_iter):
        g_new = (n_b * t2 * g_hat + d_star * g_bar) / (n_b * t2 + d_star)
        sum2 = zss - 2.0 * g_new * zs + n_b * g_new * g_new
        d_new = (b_prior + 0.5 * sum2) / (n_b / 2.0 + a_prior - 1.0)
        change = max(
            np.abs(g_new - g_star).max() / max(np.abs(g_star).max(), 1e-12),
            np.abs(d_new - d_star).max() / d_star.max(),
        )
        g_star, d_star = g_new, d_new
        if change < tol:
            break
    return g_star, np.maximum(d_star, 1e-12)


@precision_policy()
def combat(X, batch, *, eb: bool = True, device="cuda"):
    """ComBat batch correction (Johnson et al. 2007; scanpy ``pp.combat``
    without covariates): per-gene location / scale batch effects from the
    grouped moments (zeros included), shrunk by the parametric
    empirical-Bayes fixed point (``eb=False`` skips it), removed by one
    affine map ``x * A[batch] + C[batch]``. Returns a dense tensor."""

    if _is_sparse(X):
        n, p = X.shape
        labels, codes = X._batch_codes(list(batch), n, "row")
        sums = _host(X._batch_spmm("col", codes, "sum"), np.float64)
        sumsq = _host(X._batch_spmm("col", codes, "sumsq"), np.float64)
        dense = _dense_rows(X)
    else:
        dense = _as_dense(X, device)
        n, p = dense.shape
        batch = list(batch)
        if len(batch) != n:
            raise ValueError(f"batch vector length ({len(batch)}) != rows ({n})")
        labels = list(dict.fromkeys(batch))
        code_of = {b: i for i, b in enumerate(labels)}
        codes = np.fromiter((code_of[b] for b in batch), np.int32, n)
        onehot = np.eye(len(labels))[codes]
        Xh = dense.cpu().numpy().astype(np.float64)
        sums = Xh.T @ onehot
        sumsq = (Xh * Xh).T @ onehot

    B = len(labels)
    sizes = np.bincount(codes, minlength=B).astype(np.float64)
    if B < 2:
        return dense
    if (sizes < 2).any():
        small = [labels[i] for i in np.where(sizes < 2)[0]]
        raise ValueError(f"batches need >= 2 cells, got singletons: {small}")

    mu = sums / sizes[None, :]
    alpha = mu @ (sizes / n)
    var = ((sumsq - sizes[None, :] * mu * mu).sum(axis=1)) / n
    sigma = np.sqrt(np.maximum(var, 1e-12))
    zs = (sums - sizes[None, :] * alpha[:, None]) / sigma[:, None]
    zss = (sumsq - 2.0 * alpha[:, None] * sums
           + sizes[None, :] * (alpha ** 2)[:, None]) / (sigma ** 2)[:, None]

    A = np.empty((B, p), np.float64)
    C = np.empty((B, p), np.float64)
    for b in range(B):
        if eb:
            g_star, d_star = _combat_eb(zs[:, b], zss[:, b], sizes[b])
        else:
            g_star = zs[:, b] / sizes[b]
            d_star = np.maximum(
                (zss[:, b] - sizes[b] * g_star * g_star) / (sizes[b] - 1.0), 1e-12)
        d_std = np.sqrt(d_star)
        A[b] = 1.0 / d_std
        C[b] = alpha - (alpha + sigma * g_star) / d_std

    At = torch.as_tensor(A, dtype=dense.dtype, device=dense.device)
    Ct = torch.as_tensor(C, dtype=dense.dtype, device=dense.device)
    ct = torch.as_tensor(np.asarray(codes, np.int64), device=dense.device)
    return dense * At[ct] + Ct[ct]


# ----------------------------------------------------------------------
# sampling utilities
# ----------------------------------------------------------------------


def subsample(m, *, fraction: Optional[float] = None,
              n_obs: Optional[int] = None, seed: int = 0):
    """Random cell subset (scanpy ``pp.subsample``): exactly one of
    ``fraction`` / ``n_obs``. Returns ``(subset_matrix, row_indices)``,
    indices ascending (numpy ``default_rng(seed)``: the JAX package's
    draw)."""

    n = m.shape[0]
    if (fraction is None) == (n_obs is None):
        raise ValueError("provide exactly one of fraction / n_obs")
    if fraction is not None:
        if not (0 < fraction <= 1):
            raise ValueError(f"fraction={fraction} must be in (0, 1]")
        n_obs = max(1, int(round(fraction * n)))
    if not (1 <= n_obs <= n):
        raise ValueError(f"n_obs={n_obs} must be in [1, {n}]")
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(n, size=n_obs, replace=False))
    return m.select_rows(idx), idx


def downsample_counts(m, counts_per_cell: float, *, seed: int = 0, device="cuda"):
    """Downsample raw counts so no cell exceeds ``counts_per_cell`` total
    (scanpy ``pp.downsample_counts``): exact sampling without replacement
    per cell (multivariate hypergeometric over its stored genes), cells at
    or below the target untouched. Needs integer counts; returns a new
    SparseMatrix on ``m``'s device (``device`` for a scipy input)."""

    import scipy.sparse as sp

    target = int(counts_per_cell)
    if target < 1:
        raise ValueError(f"counts_per_cell={counts_per_cell} must be >= 1")
    if isinstance(m, SparseMatrix):
        X, device = m.to_scipy().tocsr(), m.device
    else:
        X = sp.csr_matrix(m)
    data = X.data
    counts = np.rint(data).astype(np.int64)
    if not np.allclose(data, counts, atol=1e-6) or (counts < 0).any():
        raise ValueError("downsample_counts needs non-negative integer count data")
    rng = np.random.default_rng(seed)
    new_data = counts.copy()
    indptr = X.indptr
    for i in range(X.shape[0]):
        lo, hi = indptr[i], indptr[i + 1]
        row = counts[lo:hi]
        if int(row.sum()) > target:
            new_data[lo:hi] = rng.multivariate_hypergeometric(row, target)
    out = sp.csr_matrix(
        (new_data.astype(X.data.dtype), X.indices.copy(), indptr.copy()), shape=X.shape)
    out.eliminate_zeros()
    return SparseMatrix.from_scipy(out, device=device)
