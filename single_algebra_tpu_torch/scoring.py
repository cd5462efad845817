"""Gene-set scoring: ``score_genes`` / ``score_genes_cell_cycle``.

Counterpart of ``single_algebra_tpu/scoring.py`` (scanpy's
``tl.score_genes``): a cell's score is the mean expression of the
signature genes minus the mean of an expression-matched control set
(``ctrl_size`` genes drawn per expression bin, Satija et al. 2015). Both
means are masked row reductions (``sum_row_masked``) on the matrix's
device; the control draw is ``np.random.default_rng(seed)``, the JAX
package's own draw, so both packages pick the same controls.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .types import precision_policy

__all__ = ["score_genes", "score_genes_cell_cycle"]


def _resolve_genes(genes, var_names, p: int) -> np.ndarray:
    """Gene list (names or ints) -> int index array."""

    genes = list(genes)
    if len(genes) == 0:
        raise ValueError("gene list is empty")
    if all(isinstance(g, (int, np.integer)) for g in genes):
        idx = np.asarray(genes, np.int64)
        if (idx < 0).any() or (idx >= p).any():
            raise ValueError(f"gene indices must be in [0, {p})")
        return idx
    if var_names is None:
        raise ValueError("gene names given but var_names is None")
    lookup = {g: i for i, g in enumerate(np.asarray(var_names))}
    missing = [g for g in genes if g not in lookup]
    if missing:
        raise ValueError(f"genes not in var_names: {missing[:5]!r}")
    return np.asarray([lookup[g] for g in genes], np.int64)


@precision_policy()
def score_genes(
    m,
    gene_list: Sequence,
    *,
    var_names: Optional[Sequence] = None,
    ctrl_size: int = 50,
    n_bins: int = 25,
    seed: int = 0,
) -> np.ndarray:
    """Per-cell signature score: ``mean(X[:, signature]) -
    mean(X[:, controls])``, the controls ``ctrl_size`` genes drawn
    (seeded) from each expression bin that holds a signature gene. Input
    should be log-normalized. Returns an [n] float64 host array."""

    n, p = m.shape
    sig = np.unique(_resolve_genes(gene_list, var_names, p))

    # mean expression per gene (zeros included) drives the binning
    gene_means = m.sum_col().cpu().numpy().astype(np.float64) / n
    order = np.argsort(gene_means, kind="stable")
    ranks = np.empty(p, np.int64)
    ranks[order] = np.arange(p)
    bins = (ranks * n_bins) // p  # equal-size expression bins

    rng = np.random.default_rng(seed)
    ctrl: list = []
    for b in np.unique(bins[sig]):
        pool = np.where(bins == b)[0]
        pool = pool[~np.isin(pool, sig)]
        if len(pool) == 0:
            continue
        ctrl.append(rng.choice(pool, size=min(ctrl_size, len(pool)), replace=False))
    if not ctrl:
        raise ValueError("no control genes available (signature covers its bins)")
    ctrl_idx = np.unique(np.concatenate(ctrl))

    sig_mask = np.zeros(p, bool)
    sig_mask[sig] = True
    ctrl_mask = np.zeros(p, bool)
    ctrl_mask[ctrl_idx] = True

    sig_mean = m.sum_row_masked(sig_mask).cpu().numpy().astype(np.float64) / len(sig)
    ctrl_mean = m.sum_row_masked(ctrl_mask).cpu().numpy().astype(np.float64) / len(ctrl_idx)
    return sig_mean - ctrl_mean


def score_genes_cell_cycle(
    m,
    s_genes: Sequence,
    g2m_genes: Sequence,
    *,
    var_names: Optional[Sequence] = None,
    ctrl_size: Optional[int] = None,
    n_bins: int = 25,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cell-cycle scoring (scanpy ``tl.score_genes_cell_cycle``):
    ``(s_score, g2m_score, phase)``, phase in {'S', 'G2M', 'G1'} (the
    argmax score if positive, else G1). ``ctrl_size`` defaults to the
    signature length."""

    s_genes, g2m_genes = list(s_genes), list(g2m_genes)
    kw = dict(var_names=var_names, n_bins=n_bins, seed=seed)
    s_score = score_genes(m, s_genes, ctrl_size=len(s_genes) if ctrl_size is None else ctrl_size,
                          **kw)
    g2m_score = score_genes(m, g2m_genes,
                            ctrl_size=len(g2m_genes) if ctrl_size is None else ctrl_size, **kw)
    phase = np.where(
        (s_score <= 0) & (g2m_score <= 0),
        "G1",
        np.where(s_score > g2m_score, "S", "G2M"),
    )
    return s_score, g2m_score, phase
