"""One-call preprocessing recipes (scanpy ``pp.recipe_*`` role).

Counterpart of ``single_algebra_tpu/recipes.py``: each recipe chains the
port's QC, normalization, HVG selection and scaling in the published
order, on the matrix's device, and returns the model-ready dense tensor
plus the masks and statistics produced along the way:

    Z, info = recipe_zheng17(m)          # dense [n, 1000] tensor, scaled
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .types import precision_policy

__all__ = ["recipe_zheng17", "recipe_seurat", "recipe_pearson_residuals"]


@precision_policy()
def recipe_seurat(
    m,
    *,
    min_genes: int = 200,
    min_cells: int = 3,
    log: bool = True,
    scale_max: float = 10.0,
) -> Tuple["torch.Tensor", Dict]:
    """Seurat-flavor preprocessing (scanpy ``pp.recipe_seurat``):

    1. drop cells with < ``min_genes`` detected genes and genes seen in
       < ``min_cells`` cells,
    2. total-count normalize to 1e4,
    3. log1p,
    4. Seurat dispersion-cutoff HVG selection (the classic
       min_mean/max_mean/min_disp box, NOT a top-N ranking),
    5. subset, scale to unit variance clipped at ``scale_max``.

    Returns ``(Z, info)``: Z dense [n_kept, n_hvg]; info carries
    ``cell_mask`` / ``gene_mask`` over the ORIGINAL axes and ``hvg``.
    """

    from .feature_selection import highly_variable_genes
    from .preprocess import scale
    from .qc import filter_cells, filter_genes
    from .types import Direction

    n, p = m.shape
    kept_cells, cell_mask = filter_cells(m, min_genes=min_genes)
    kept, counts_mask = filter_genes(kept_cells, min_cells=min_cells)

    sums = kept.sum_row().cpu().numpy()
    norm = kept.normalize(sums, 1e4, Direction.ROW)
    if log:
        norm = norm.log1p_normalize()

    hvg = highly_variable_genes(norm, flavor="seurat")
    sub = norm.select_cols(hvg.mask)
    Z = scale(sub, max_value=scale_max)

    gene_mask = np.zeros(p, bool)
    gene_mask[np.where(counts_mask)[0][hvg.mask]] = True
    return Z, {
        "cell_mask": cell_mask,
        "gene_mask": gene_mask,
        "counts_mask": counts_mask,
        "hvg": hvg,
    }


@precision_policy()
def recipe_pearson_residuals(
    m,
    *,
    n_top_genes: int = 1000,
    theta: float = 100.0,
    clip=None,
    min_genes: int = 200,
    min_cells: int = 3,
    batches=None,
) -> Tuple["torch.Tensor", Dict]:
    """Pearson-residuals preprocessing (scanpy
    ``experimental.pp.recipe_pearson_residuals``; Lause et al. 2021):

    1. drop cells with < ``min_genes`` detected genes and genes seen in
       < ``min_cells`` cells (on RAW counts),
    2. HVG selection by clipped-residual variance (the tiled device
       pass — no dense residuals),
    3. subset to the HVGs,
    4. transform the kept counts to clipped analytic Pearson residuals
       (residuals recomputed on the SUBSET counts, scanpy order).

    Returns ``(Z, info)``: Z dense [n_kept, n_top_genes] residuals ready
    for PCA; info carries ``cell_mask`` / ``gene_mask`` over the
    ORIGINAL axes and ``hvg``.
    """

    from .feature_selection import highly_variable_genes
    from .preprocess import normalize_pearson_residuals
    from .qc import filter_cells, filter_genes

    n, p = m.shape
    kept_cells, cell_mask = filter_cells(m, min_genes=min_genes)
    kept, counts_mask = filter_genes(kept_cells, min_cells=min_cells)
    if batches is not None:
        batches = np.asarray(batches)
        if batches.shape[0] != n:
            raise ValueError(
                f"batches length ({batches.shape[0]}) != cells ({n})"
            )
        batches = batches[np.asarray(cell_mask, bool)]  # follow the filter

    hvg = highly_variable_genes(
        kept,
        flavor="pearson_residuals",
        n_top_genes=min(n_top_genes, kept.ncols),
        theta=theta,
        clip=clip,
        batches=batches,
    )
    sub = kept.select_cols(hvg.mask)
    Z = normalize_pearson_residuals(sub, theta=theta, clip=clip)

    gene_mask = np.zeros(p, bool)
    gene_mask[np.where(counts_mask)[0][hvg.mask]] = True
    return Z, {
        "cell_mask": cell_mask,
        "gene_mask": gene_mask,
        "counts_mask": counts_mask,
        "hvg": hvg,
    }


@precision_policy()
def recipe_zheng17(
    m,
    *,
    n_top_genes: int = 1000,
    log: bool = True,
    scale_max: float = 10.0,
) -> Tuple["torch.Tensor", Dict]:
    """Zheng et al. 2017 (10x 68k PBMC) preprocessing, scanpy order:

    1. drop zero-count genes,
    2. total-count normalize to the per-cell MEDIAN,
    3. CellRanger-flavor HVG ranking, keep ``n_top_genes``,
    4. subset + re-normalize the kept genes,
    5. log1p (``log=False`` skips, as scanpy allows),
    6. scale to unit variance, clipped at ``scale_max``.

    Returns ``(Z, info)``: Z a dense tensor on the matrix's device [n, n_top_genes]
    ready for PCA; info carries ``gene_mask`` (over the ORIGINAL
    columns), ``hvg`` (the HVGResult), and ``counts_mask`` from step 1.
    """

    from .feature_selection import highly_variable_genes
    from .preprocess import scale
    from .qc import filter_genes
    from .types import Direction

    n, p = m.shape
    kept, counts_mask = filter_genes(m, min_counts=1)

    sums = kept.sum_row().cpu().numpy()
    target = float(np.median(sums[sums > 0]))
    norm = kept.normalize(sums, target, Direction.ROW)

    hvg = highly_variable_genes(
        norm, n_top_genes=min(n_top_genes, kept.ncols),
        flavor="cell_ranger",
    )
    sub = norm.select_cols(hvg.mask)

    sums2 = sub.sum_row().cpu().numpy()
    target2 = float(np.median(sums2[sums2 > 0]))
    sub = sub.normalize(sums2, target2, Direction.ROW)
    if log:
        sub = sub.log1p_normalize()

    Z = scale(sub, max_value=scale_max)

    gene_mask = np.zeros(p, bool)
    gene_mask[np.where(counts_mask)[0][hvg.mask]] = True
    return Z, {
        "gene_mask": gene_mask,
        "hvg": hvg,
        "counts_mask": counts_mask,
        "target_sum": target,
    }
