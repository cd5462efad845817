"""Highly-variable-gene (HVG) selection over sparse expression matrices.

Counterpart of ``single_algebra_tpu/feature_selection.py``: the four
flavors (``seurat``, ``cell_ranger``, ``seurat_v3``,
``pearson_residuals``), batch-aware selection, and selection from
precomputed moments. The O(nnz) work runs on the matrix's device: the
``expm1`` undo of log-normalized values (``sparse.matrix._expm1_fn``), the
column moments and the grouped per-batch moments (the device ELL
reductions), seurat_v3's clipped column sums, and the Pearson residual
variance in gene x row blocks. Only p-length vectors reach the host,
where the binning, the normalized dispersions, the loess fit and the
ranking are the JAX package's numpy code, unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .qc import _host
from .sparse.matrix import _expm1_fn
from .types import precision_policy

__all__ = [
    "HVGResult",
    "highly_variable_genes",
    "highly_variable_genes_from_moments",
]


@dataclasses.dataclass
class HVGResult:
    """Per-gene selection scores and the boolean mask.

    ``mask`` plugs directly into ``MaskedSparsePCABuilder.mask``.
    """

    mask: np.ndarray  # bool [p]
    means: np.ndarray  # f32/f64 [p] (pre-log mean of the expm1'd data)
    dispersions: np.ndarray  # f32/f64 [p]
    dispersions_norm: np.ndarray  # f32/f64 [p]
    n_batches_selected: Optional[np.ndarray] = None  # int [p] (batch mode)

    @property
    def n_selected(self) -> int:
        return int(self.mask.sum())

    def __repr__(self):
        return (
            f"HVGResult(n_selected={self.n_selected} of {self.mask.size})"
        )


def _col_moments(x, assume_logged: bool):
    """Per-gene (mean, Bessel var over all rows) on the device, returned as
    host arrays in the matrix's dtype."""

    if assume_logged:
        # the column layout first, so the map carries it as a twin (one
        # transpose of x for every call)
        x._layout_for("col")
        xe = x.map_stored(_expm1_fn)
    else:
        xe = x
    n = xe.nrows
    mean = xe.sum_col() / n
    var = xe.var_col()
    return mean.cpu().numpy(), var.cpu().numpy()


def _batch_col_moments(x, batches: Sequence, assume_logged: bool):
    """Per-batch per-gene (mean, Bessel var incl. zeros) from the grouped
    one-hot products (one device pass per moment for all batches)."""

    if assume_logged:
        x._layout_for("col")
        xe = x.map_stored(_expm1_fn)
    else:
        xe = x
    labels, codes = xe._batch_codes(batches, xe.nrows, "row")
    sums = xe._batch_spmm("col", codes, "sum").cpu().numpy()
    sumsq = xe._batch_spmm("col", codes, "sumsq").cpu().numpy()
    sizes = np.bincount(codes, minlength=len(labels)).astype(sums.dtype)
    out = []
    for i, b in enumerate(labels):
        nb = max(float(sizes[i]), 1.0)
        mean = sums[:, i] / nb
        var = (sumsq[:, i] / nb - mean * mean) * (nb / max(nb - 1.0, 1.0))
        out.append((b, mean, np.maximum(var, 0.0)))
    return out


def _loess_fit(
    x: np.ndarray, y: np.ndarray, *, frac: float = 0.3, degree: int = 2
) -> np.ndarray:
    """Local polynomial regression (loess, gaussian family, no robustness
    iterations — the configuration scanpy's seurat_v3 uses via skmisc).

    For each point, the ``ceil(frac*n)`` nearest neighbors in x (a
    contiguous window in sorted order) are tricube-weighted and a
    degree-``degree`` weighted polynomial is solved; the fit at the point
    is the local intercept (x is centered per window). Vectorized in
    blocks: windows are contiguous spans of sorted x, so they gather from
    a sliding-window view; the per-point normal equations solve as one
    batched [B, d+1, d+1] ``np.linalg.solve``. O(n * window) host work on
    p-length gene vectors.
    """

    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    n = x.size
    if n == 0:
        return np.empty(0, np.float64)
    q = int(np.ceil(frac * n))
    q = max(min(q, n), min(degree + 1, n))
    order = np.argsort(x, kind="stable")
    xs, ys = x[order], y[order]

    # leftmost window start per point: slide right while the entering
    # point is closer than the leaving one (classic lowess two-pointer)
    starts = np.empty(n, np.int64)
    lo = 0
    for i in range(n):
        while lo + q < n and xs[i] - xs[lo] > xs[lo + q] - xs[i]:
            lo += 1
        starts[i] = lo

    xw = np.lib.stride_tricks.sliding_window_view(xs, q)
    yw = np.lib.stride_tricks.sliding_window_view(ys, q)
    fitted_s = np.empty(n, np.float64)
    d1 = degree + 1
    for b0 in range(0, n, 512):
        b1 = min(n, b0 + 512)
        s = starts[b0:b1]
        Xc = xw[s] - xs[b0:b1, None]  # centered [B, q]
        Y = yw[s]
        dist = np.abs(Xc)
        dmax = dist.max(axis=1, keepdims=True)
        flat = dmax == 0  # all-identical x: uniform weights
        dmax = np.where(flat, 1.0, dmax)
        w = (1.0 - np.minimum(dist / dmax, 1.0) ** 3) ** 3
        w = np.where(flat, 1.0, w)
        # powers of the centered x, weighted moments S_k = sum w x^k
        pw = [np.ones_like(Xc)]
        for _ in range(2 * degree):
            pw.append(pw[-1] * Xc)
        S = np.stack([(w * p).sum(axis=1) for p in pw], axis=1)
        A = np.empty((b1 - b0, d1, d1))
        for k in range(d1):
            for l in range(d1):
                A[:, k, l] = S[:, k + l]
        rhs = np.stack(
            [(w * pw[k] * Y).sum(axis=1) for k in range(d1)], axis=1
        )
        # tiny scale-aware ridge keeps degenerate windows solvable
        eps = 1e-12 * np.maximum(
            A.reshape(b1 - b0, -1).max(axis=1), 1.0
        )
        A[:, np.arange(d1), np.arange(d1)] += eps[:, None]
        beta = np.linalg.solve(A, rhs[..., None])[..., 0]
        fitted_s[b0:b1] = beta[:, 0]  # value at the (centered) point

    fitted = np.empty(n, np.float64)
    fitted[order] = fitted_s
    return fitted


def _clipped_col_sums(x, clip: np.ndarray):
    """Per-gene sum and sum of squares of ``min(x, clip_g)`` over stored
    entries, on the column-major ELL (major lines are genes). Implicit
    zeros clip to zero (clip >= 0), so the stored entries suffice."""

    mc = x._layout_for("col")
    ed, ids, nz = mc.ell_data, mc.ell_ids, mc.row_nnz
    clip_pad = torch.zeros(ed.shape[0], dtype=ed.dtype, device=ed.device)
    clip_pad[: clip.shape[0]] = torch.as_tensor(clip, dtype=ed.dtype)
    valid = torch.arange(ed.shape[1], device=ed.device)[None, :] < nz[:, None]
    v = torch.where(valid, torch.minimum(ed, clip_pad[:, None]), torch.zeros_like(ed))
    p = x.ncols
    return _host(v.sum(dim=1)[:p], np.float64), _host((v * v).sum(dim=1)[:p], np.float64)


def _seurat_v3_norm_var(x) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mean, raw gene variance, clipped standardized variance) for one
    batch: the seurat_v3 variance-stabilizing score (Stuart et al. 2019).
    A loess (span 0.3, degree 2) of log10(var) on log10(mean) regularizes
    the standard deviation; counts clip at ``mean + reg_std * sqrt(n)``
    and the variance of the clipped, standardized counts comes from the
    clipped column sums."""

    n, p = x.nrows, x.ncols
    mean = _host(x.sum_col(), np.float64) / max(n, 1)
    var = _host(x.var_col(), np.float64)
    not_const = (var > 0) & (mean > 0)
    est = np.zeros(p, np.float64)
    if not_const.any():
        est[not_const] = _loess_fit(np.log10(mean[not_const]), np.log10(var[not_const]))
    reg_std = np.sqrt(np.power(10.0, est))

    clip = mean + reg_std * np.sqrt(n)
    s1, s2 = _clipped_col_sums(x, clip)
    denom = max(n - 1, 1) * np.square(reg_std)
    norm_var = np.where(
        not_const,
        (n * np.square(mean) + s2 - 2.0 * s1 * mean) / denom,
        0.0,
    )
    return mean, var, norm_var


def _hvg_seurat_v3(
    x, *, n_top_genes: Optional[int], batches: Optional[Sequence],
    assume_logged: Optional[bool],
) -> HVGResult:
    """flavor='seurat_v3': variance-stabilized ranking on RAW counts.

    Batch mode follows scanpy's rule: per-batch normalized variances are
    rank-transformed, ranks past n_top_genes are dropped, and genes sort
    by (number of batches ranking them, median in-top rank); the reported
    score is the mean normalized variance across batches.
    """

    if n_top_genes is None:
        raise ValueError(
            "flavor='seurat_v3' requires n_top_genes (scanpy rule)"
        )
    if not 1 <= n_top_genes <= x.ncols:
        raise ValueError(
            f"n_top_genes={n_top_genes} out of range [1, {x.ncols}]"
        )
    if assume_logged:
        raise ValueError(
            "flavor='seurat_v3' expects RAW counts "
            "(assume_logged must be False/None)"
        )
    p = x.ncols
    if batches is None:
        mean, var, norm_var = _seurat_v3_norm_var(x)
        order = np.argsort(-norm_var, kind="stable")
        mask = np.zeros(p, dtype=bool)
        mask[order[:n_top_genes]] = True
        return HVGResult(
            mask=mask, means=mean, dispersions=var,
            dispersions_norm=norm_var,
        )

    labels, codes = x._batch_codes(list(batches), x.nrows, "row")
    ranks = []  # per-batch in-top-n rank, NaN outside the top n
    norm_vars = []
    for b in range(len(labels)):
        sub = x.select_rows(np.where(codes == b)[0])
        _, _, nv_b = _seurat_v3_norm_var(sub)
        norm_vars.append(nv_b)
        r = np.full(p, np.nan)
        order_b = np.argsort(-nv_b, kind="stable")
        r[order_b[:n_top_genes]] = np.arange(n_top_genes, dtype=np.float64)
        ranks.append(r)
    ranks = np.stack(ranks)
    votes = np.sum(~np.isnan(ranks), axis=0).astype(np.int64)
    med_rank = np.full(p, np.inf)
    any_rank = votes > 0  # all-NaN columns stay +inf (sort last)
    if any_rank.any():
        med_rank[any_rank] = np.nanmedian(ranks[:, any_rank], axis=0)
    sel = np.lexsort((med_rank, -votes))
    mask = np.zeros(p, dtype=bool)
    mask[sel[:n_top_genes]] = True
    mean = _host(x.sum_col(), np.float64) / max(x.nrows, 1)
    var = _host(x.var_col(), np.float64)
    return HVGResult(
        mask=mask, means=mean, dispersions=var,
        dispersions_norm=np.mean(np.stack(norm_vars), axis=0),
        n_batches_selected=votes,
    )


def _normalized_dispersion(
    mean: np.ndarray, var: np.ndarray, flavor: str, n_bins: int
):
    """(dispersion, dispersion_norm) for one batch of column moments.

    p-length host arithmetic — negligible next to the device reductions.
    """

    with np.errstate(divide="ignore", invalid="ignore"):
        disp = np.where(mean > 0, var / np.where(mean > 0, mean, 1.0), 0.0)

    if flavor == "seurat":
        score = np.where(disp > 0, np.log(np.where(disp > 0, disp, 1.0)), np.nan)
        key = np.log1p(mean)
        # equal-width bins over the finite key range
        lo, hi = float(key.min()), float(key.max())
        width = (hi - lo) or 1.0
        bin_id = np.clip(
            ((key - lo) / width * n_bins).astype(np.int64), 0, n_bins - 1
        )
        norm = np.zeros_like(score)
        for b in range(n_bins):
            sel = bin_id == b
            vals = score[sel]
            ok = np.isfinite(vals)
            if ok.sum() > 1:
                m, s = vals[ok].mean(), vals[ok].std(ddof=1)
                norm[sel] = np.where(
                    np.isfinite(vals), (vals - m) / (s if s > 0 else 1.0), 0.0
                )
            # single-gene / empty bins keep score 0 (no within-bin scale)
        return disp, norm

    if flavor == "cell_ranger":
        # quantile bins over the mean; robust median/MAD z-score
        score = disp.astype(np.float64)
        edges = np.quantile(mean, np.linspace(0, 1, n_bins + 1))
        edges = np.unique(edges)
        bin_id = np.clip(
            np.searchsorted(edges, mean, side="right") - 1, 0, len(edges) - 2
        )
        norm = np.zeros_like(score)
        for b in range(len(edges) - 1):
            sel = bin_id == b
            vals = score[sel]
            if vals.size > 1:
                med = np.median(vals)
                mad = np.median(np.abs(vals - med))
                norm[sel] = (vals - med) / (mad if mad > 0 else 1.0)
        return disp, norm

    raise ValueError(
        f"Unknown flavor {flavor!r}; expected 'seurat', 'cell_ranger', "
        "'seurat_v3', or 'pearson_residuals'"
    )


# elements of one [rows, genes] zero-part tile of the Pearson variance
_PEARSON_TILE = 1 << 24


def _pearson_var_blocks(ed, ei, nz, g, t, theta, clip, gene_block: int, n_real: int):
    """Per-gene variance of clipped analytic Pearson residuals, never
    materializing the dense ``[n, p]`` residuals: the JAX package's
    ``_pearson_var_graph`` (a scan over gene blocks with a row-block
    loop inside) as a loop over gene blocks of the column-major ELL
    (``ed``/``ei`` ``[R, w]``, ``nz``/``g`` ``[R]``). Per block, the
    zero-entry part ``sum_i f(t_i * p_g)`` runs over ``[rows, GB]`` tiles of
    at most ``_PEARSON_TILE`` elements; then the stored entries swap their
    zero-part term for the true residual. Zero-total cells and genes
    contribute zero residuals (no NaNs)."""

    total = t.sum()
    total = torch.where(total > 0, total, torch.ones_like(total))
    R, w = ed.shape
    rank = torch.arange(w, device=ed.device)[None, :]
    var = torch.empty(R, dtype=ed.dtype, device=ed.device)
    for g0 in range(0, R, gene_block):
        g1 = min(g0 + gene_block, R)
        pg = g[g0:g1] / total
        rb = max(1, _PEARSON_TILE // (g1 - g0))
        s = torch.zeros(g1 - g0, dtype=ed.dtype, device=ed.device)
        ss = torch.zeros_like(s)
        for r0 in range(0, t.shape[0], rb):
            mu = t[r0:r0 + rb, None] * pg[None, :]
            r0v = torch.clamp(-torch.sqrt(mu / (1.0 + mu / theta)), min=-clip)
            s += r0v.sum(dim=0)
            ss += (r0v * r0v).sum(dim=0)
        ids = ei[g0:g1].long()
        mu_e = t[ids] * pg[:, None]
        valid = (rank < nz[g0:g1, None]) & (mu_e > 0)
        safe = torch.where(valid, mu_e, torch.ones_like(mu_e))
        sig = torch.sqrt(safe + safe * safe / theta)
        r = torch.clamp((ed[g0:g1] - safe) / sig, -clip, clip)
        r0e = torch.clamp(-torch.sqrt(safe / (1.0 + safe / theta)), min=-clip)
        zero = torch.zeros_like(r)
        s = s + torch.where(valid, r - r0e, zero).sum(dim=1)
        ss = ss + torch.where(valid, r * r - r0e * r0e, zero).sum(dim=1)
        mean = s / n_real
        var[g0:g1] = ss / n_real - mean * mean  # np.var ddof=0 (scanpy)
    return var


def _pearson_residual_variance(x, theta: float, clip: Optional[float], *,
                               gene_block: int = 256):
    """Blocked device computation of per-gene clipped-residual variance."""

    n, p = x.shape
    if clip is None:
        clip = float(np.sqrt(n))
    mc = x._layout_for("col")  # ELL major lines are genes
    ed = mc.ell_data
    R = ed.shape[0]
    g = torch.zeros(R, dtype=ed.dtype, device=ed.device)
    g[:p] = x.sum_col().to(ed.dtype)
    t = x.sum_row().to(ed.dtype)
    var = _pearson_var_blocks(
        ed, mc.ell_ids, mc.row_nnz, g, t,
        torch.as_tensor(theta, dtype=ed.dtype, device=ed.device),
        torch.as_tensor(clip, dtype=ed.dtype, device=ed.device),
        min(gene_block, R), n,
    )
    return _host(var[:p], np.float64)


@precision_policy()
def highly_variable_genes_from_moments(
    mean,
    var,
    *,
    n_top_genes: Optional[int] = None,
    flavor: str = "seurat",
    n_bins: int = 20,
    min_mean: float = 0.0125,
    max_mean: float = 3.0,
    min_disp: float = 0.5,
    max_disp: float = float("inf"),
) -> HVGResult:
    """HVG selection from precomputed per-gene (mean, variance).

    The out-of-core entry point: ``StreamingSparsePCA`` exposes streaming
    column moments (``col_sums()`` / ``col_var()``) whose n is unbounded —
    feed them here to select HVGs without a second data pass. The moments
    must be on the PRE-LOG scale for 'seurat' cutoff semantics (apply
    ``expm1`` upstream if the stream was log1p-normalized).
    """

    mean = np.asarray(mean, np.float64).ravel()
    var = np.asarray(var, np.float64).ravel()
    if mean.shape != var.shape:
        raise ValueError("mean and var must have the same length")
    if mean.size < 1:
        raise ValueError("Matrix has no feature columns")
    if n_bins < 1:
        raise ValueError(f"n_bins={n_bins} must be >= 1")
    disp, norm = _normalized_dispersion(mean, var, flavor, n_bins)
    if n_top_genes is not None:
        if not 1 <= n_top_genes <= mean.size:
            raise ValueError(
                f"n_top_genes={n_top_genes} out of range [1, {mean.size}]"
            )
        order = np.argsort(-norm, kind="stable")
        mask = np.zeros(mean.size, dtype=bool)
        mask[order[:n_top_genes]] = True
    else:
        mask = (
            (mean > min_mean)
            & (mean < max_mean)
            & (norm > min_disp)
            & (norm < max_disp)
        )
    return HVGResult(
        mask=np.asarray(mask, dtype=bool),
        means=mean,
        dispersions=disp,
        dispersions_norm=norm,
    )


def _hvg_pearson_residuals(
    x,
    *,
    n_top_genes: Optional[int],
    theta: float,
    clip: Optional[float],
    assume_logged: Optional[bool],
    batches: Optional[Sequence],
) -> HVGResult:
    """flavor='pearson_residuals' path: rank by clipped-residual variance.

    Batch mode follows scanpy's experimental rule: residual variances are
    computed per batch (each on its own row subset, so t_i/g_g/total are
    batch-local), genes are ranked by how many batches put them in their
    top-n (ties broken by median residual variance across batches).
    """

    if n_top_genes is None:
        raise ValueError(
            "flavor='pearson_residuals' requires n_top_genes (scanpy rule)"
        )
    if not 1 <= n_top_genes <= x.ncols:
        raise ValueError(
            f"n_top_genes={n_top_genes} out of range [1, {x.ncols}]"
        )
    if not theta > 0:
        raise ValueError(f"theta={theta} must be > 0")
    if assume_logged:
        raise ValueError(
            "flavor='pearson_residuals' expects RAW counts "
            "(assume_logged must be False/None)"
        )
    p = x.ncols
    mean = _host(x.sum_col(), np.float64) / max(x.nrows, 1)
    n_sel_batches = None
    if batches is None:
        var = _pearson_residual_variance(x, theta, clip)
        order = np.argsort(-var, kind="stable")
        mask = np.zeros(p, dtype=bool)
        mask[order[:n_top_genes]] = True
    else:
        labels, codes = x._batch_codes(list(batches), x.nrows, "row")
        per_batch = []
        votes = np.zeros(p, dtype=np.int64)
        for b in range(len(labels)):
            sub = x.select_rows(np.where(codes == b)[0])
            var_b = _pearson_residual_variance(sub, theta, clip)
            per_batch.append(var_b)
            votes[np.argsort(-var_b, kind="stable")[:n_top_genes]] += 1
        var = np.median(np.stack(per_batch), axis=0)
        rank = np.lexsort((-var, -votes))
        mask = np.zeros(p, dtype=bool)
        mask[rank[:n_top_genes]] = True
        n_sel_batches = votes
    return HVGResult(
        mask=mask,
        means=mean,
        dispersions=var,
        dispersions_norm=var,
        n_batches_selected=n_sel_batches,
    )


@precision_policy()
def highly_variable_genes(
    x,
    *,
    n_top_genes: Optional[int] = None,
    flavor: str = "seurat",
    n_bins: int = 20,
    min_mean: float = 0.0125,
    max_mean: float = 3.0,
    min_disp: float = 0.5,
    max_disp: float = float("inf"),
    assume_logged: Optional[bool] = None,
    batches: Optional[Sequence] = None,
    theta: float = 100.0,
    clip: Optional[float] = None,
) -> HVGResult:
    """Select highly variable genes of a cells x genes ``SparseMatrix``.

    ``n_top_genes`` set -> rank-based selection (top normalized
    dispersions); unset -> the cutoff box (min/max mean on the pre-log
    scale, min/max normalized dispersion), matching the classic Seurat
    defaults. ``assume_logged`` defaults to True for 'seurat' (expm1 is
    applied on device before the moments) and False for 'cell_ranger'.

    ``flavor='seurat_v3'`` (Stuart et al. 2019; scanpy's default for raw
    counts) ranks genes by the variance of clipped standardized counts
    under a loess-regularized standard deviation (span 0.3, degree 2 of
    log10 var on log10 mean — see ``_loess_fit``). It expects RAW counts
    and requires ``n_top_genes``; the raw gene variance is reported in
    ``dispersions`` and the normalized variance in ``dispersions_norm``.

    ``flavor='pearson_residuals'`` (scanpy ``experimental.pp``; Lause et
    al. 2021) ranks genes by the variance of their clipped analytic
    Pearson residuals, computed in device blocks without materializing
    the dense residual matrix (see ``_pearson_var_blocks``). It expects
    RAW counts, requires ``n_top_genes``, and uses ``theta`` / ``clip``
    (default sqrt(n)); the residual variance is reported in both
    ``dispersions`` and ``dispersions_norm``.

    ``batches`` (length n_cells) computes dispersions independently per
    batch and combines by selection count — genes variable in *every*
    batch beat batch-specific artifacts.
    """

    if x.ncols < 1:
        raise ValueError("Matrix has no feature columns")
    if n_bins < 1:
        raise ValueError(f"n_bins={n_bins} must be >= 1")
    if flavor == "pearson_residuals":
        return _hvg_pearson_residuals(
            x,
            n_top_genes=n_top_genes,
            theta=theta,
            clip=clip,
            assume_logged=assume_logged,
            batches=batches,
        )
    if flavor == "seurat_v3":
        return _hvg_seurat_v3(
            x,
            n_top_genes=n_top_genes,
            batches=batches,
            assume_logged=assume_logged,
        )
    if assume_logged is None:
        assume_logged = flavor == "seurat"

    if batches is None:
        mean, var = _col_moments(x, assume_logged)
        disp, norm = _normalized_dispersion(mean, var, flavor, n_bins)
        n_sel_batches = None
    else:
        per_batch = _batch_col_moments(x, batches, assume_logged)
        norms = []
        disps = []
        for _, mean_b, var_b in per_batch:
            d_b, n_b = _normalized_dispersion(mean_b, var_b, flavor, n_bins)
            disps.append(d_b)
            norms.append(n_b)
        # combined per-gene stats: overall moments for reporting/cutoffs,
        # median of the per-batch normalized dispersions as the score
        mean, var = _col_moments(x, assume_logged)
        disp = np.median(np.stack(disps), axis=0)
        norm = np.median(np.stack(norms), axis=0)

    if n_top_genes is not None:
        if not 1 <= n_top_genes <= x.ncols:
            raise ValueError(
                f"n_top_genes={n_top_genes} out of range [1, {x.ncols}]"
            )
        if batches is None:
            order = np.argsort(-norm, kind="stable")
            mask = np.zeros(x.ncols, dtype=bool)
            mask[order[:n_top_genes]] = True
        else:
            # scanpy's batch rule: per-batch top-n votes first, median
            # normalized dispersion breaks ties
            votes = np.zeros(x.ncols, dtype=np.int64)
            for n_b in norms:
                order_b = np.argsort(-n_b, kind="stable")[:n_top_genes]
                votes[order_b] += 1
            rank = np.lexsort((-norm, -votes))
            mask = np.zeros(x.ncols, dtype=bool)
            mask[rank[:n_top_genes]] = True
            n_sel_batches = votes
    else:
        mask = (
            (mean > min_mean)
            & (mean < max_mean)
            & (norm > min_disp)
            & (norm < max_disp)
        )
        if batches is not None:
            votes = np.zeros(x.ncols, dtype=np.int64)
            for (_, mean_b, _), n_b in zip(per_batch, norms):
                votes += (
                    (mean_b > min_mean)
                    & (mean_b < max_mean)
                    & (n_b > min_disp)
                    & (n_b < max_disp)
                ).astype(np.int64)
            mask = votes == len(per_batch)
            n_sel_batches = votes

    if batches is not None and n_sel_batches is None:
        n_sel_batches = np.zeros(x.ncols, dtype=np.int64)

    return HVGResult(
        mask=np.asarray(mask, dtype=bool),
        means=mean,
        dispersions=disp,
        dispersions_norm=norm,
        n_batches_selected=n_sel_batches,
    )
