"""Per-cell / per-gene QC metrics over the device reductions.

Counterpart of ``single_algebra_tpu/qc.py`` (scanpy's
``pp.calculate_qc_metrics`` surface): ``nonzero_row`` / ``sum_row`` /
``sum_row_masked`` and their column duals run on the matrix's device over
its padded-ELL layouts; only n- and p-length vectors reach the host, where
the frames are numpy arrays as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from .types import precision_policy

__all__ = ["calculate_qc_metrics", "filter_cells", "filter_genes"]


def _host(t, dtype=None) -> np.ndarray:
    """A device statistic as a host array (in ``dtype`` when given)."""

    out = t.cpu().numpy()
    return out if dtype is None else out.astype(dtype)


@precision_policy()
def calculate_qc_metrics(
    m,
    *,
    qc_vars: Optional[Mapping[str, np.ndarray]] = None,
    log1p: bool = True,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """QC metric frames for a cells x genes matrix of raw counts.

    Returns ``(obs, var)`` dicts of numpy arrays:

    obs (per cell): ``n_genes_by_counts``, ``total_counts``
    (+ ``log1p_*`` when ``log1p=True``), and per ``qc_vars`` entry
    ``total_counts_<name>`` / ``pct_counts_<name>``.

    var (per gene): ``n_cells_by_counts``, ``total_counts``,
    ``mean_counts``, ``pct_dropout_by_counts`` (+ log1p variants).

    ``qc_vars`` maps names to boolean GENE masks (length p)."""

    n, p = m.shape
    if n < 1 or p < 1:
        raise ValueError(f"Matrix has empty shape {m.shape}")

    obs: Dict[str, np.ndarray] = {}
    var: Dict[str, np.ndarray] = {}

    obs["n_genes_by_counts"] = _host(m.nonzero_row())
    total = _host(m.sum_row(), np.float64)
    obs["total_counts"] = total

    var["n_cells_by_counts"] = _host(m.nonzero_col())
    gtotal = _host(m.sum_col(), np.float64)
    var["total_counts"] = gtotal
    var["mean_counts"] = gtotal / n
    var["pct_dropout_by_counts"] = 100.0 * (1.0 - var["n_cells_by_counts"] / n)

    if log1p:
        obs["log1p_n_genes_by_counts"] = np.log1p(obs["n_genes_by_counts"])
        obs["log1p_total_counts"] = np.log1p(total)
        var["log1p_total_counts"] = np.log1p(gtotal)
        var["log1p_mean_counts"] = np.log1p(var["mean_counts"])

    denom = np.maximum(total, 1e-30)
    for name, mask in (qc_vars or {}).items():
        mask = np.asarray(mask)
        if mask.dtype != bool or mask.shape != (p,):
            raise ValueError(f"qc_vars[{name!r}] must be a bool mask of length {p}")
        sub = _host(m.sum_row_masked(mask), np.float64)
        obs[f"total_counts_{name}"] = sub
        obs[f"pct_counts_{name}"] = 100.0 * sub / denom
        if log1p:
            obs[f"log1p_total_counts_{name}"] = np.log1p(sub)

    return obs, var


def _keep(counts_fn, sums_fn, size: int, lo_n, hi_n, lo_c, hi_c) -> np.ndarray:
    keep = np.ones(size, bool)
    if lo_n is not None or hi_n is not None:
        g = _host(counts_fn())
        if lo_n is not None:
            keep &= g >= lo_n
        if hi_n is not None:
            keep &= g <= hi_n
    if lo_c is not None or hi_c is not None:
        c = _host(sums_fn(), np.float64)
        if lo_c is not None:
            keep &= c >= lo_c
        if hi_c is not None:
            keep &= c <= hi_c
    return keep


@precision_policy()
def filter_cells(
    m,
    *,
    min_genes: Optional[int] = None,
    max_genes: Optional[int] = None,
    min_counts: Optional[float] = None,
    max_counts: Optional[float] = None,
):
    """Remove cells failing QC thresholds (scanpy ``pp.filter_cells``, all
    criteria combinable). Returns ``(filtered_matrix, keep_mask)``."""

    keep = _keep(m.nonzero_row, m.sum_row, m.shape[0],
                 min_genes, max_genes, min_counts, max_counts)
    return m.select_rows(keep), keep


@precision_policy()
def filter_genes(
    m,
    *,
    min_cells: Optional[int] = None,
    max_cells: Optional[int] = None,
    min_counts: Optional[float] = None,
    max_counts: Optional[float] = None,
):
    """Remove genes failing QC thresholds (scanpy ``pp.filter_genes``).
    Returns ``(filtered_matrix, keep_mask)``."""

    keep = _keep(m.nonzero_col, m.sum_col, m.shape[1],
                 min_cells, max_cells, min_counts, max_counts)
    return m.select_cols(keep), keep
