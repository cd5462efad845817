"""Latent semantic indexing: the scATAC dimensionality reduction.

Counterpart of ``single_algebra_tpu/models/lsi.py`` (Signac ``RunSVD`` /
muon ``atac.tl.lsi``): TF-IDF (``preprocess.tfidf``), then a truncated
UNcentered randomized SVD over the engine seam
(``make_engine_operator``). On a card, ``auto`` takes the engine the
matrix fits: at ATAC widths (past 40,960 columns) the tiled engine, whose
``tiled_ell_spmm_t`` / ``tiled_ell_rmv_t`` kernels then run on TF-IDF
values (not bf16-exact: a hi and a lo payload).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..types import precision_policy

__all__ = ["LSIResult", "lsi"]


@dataclasses.dataclass
class LSIResult:
    """``scores`` [n, k] cell embeddings (U * S), ``components`` [k, p],
    ``singular_values`` [k], ``explained_variance_ratio`` [k] (variance
    of each score column over the total TF-IDF variance: the
    TruncatedSVD convention). With ``drop_first`` component 0 (the
    depth-correlated one) is already removed from every field."""

    scores: np.ndarray
    components: np.ndarray
    singular_values: np.ndarray
    explained_variance_ratio: np.ndarray

    @property
    def n_components(self) -> int:
        return int(self.singular_values.shape[0])

    def __repr__(self):
        return f"LSIResult(n_components={self.n_components}, n_cells={self.scores.shape[0]})"


@precision_policy()
def lsi(
    m,
    n_components: int = 50,
    *,
    apply_tfidf: bool = True,
    scale_factor: float = 1e4,
    log_tf: bool = True,
    log_idf: bool = True,
    log_tfidf: bool = False,
    drop_first: bool = True,
    engine: str = "auto",
    n_oversamples: int = 10,
    n_power_iterations: int = 7,
    seed: int = 42,
    scale_embeddings: bool = True,
) -> LSIResult:
    """LSI of a cells x peaks ``SparseMatrix``: TF-IDF -> truncated SVD on
    the matrix's device.

    ``drop_first=True`` (Signac / muon) fits one extra component and
    removes the first, which tracks sequencing depth. ``scale_embeddings``
    z-scores each score column (muon's default); ``singular_values`` stay
    as they are. ``apply_tfidf=False`` takes an input already TF-IDF'd.
    """

    from ..linalg import randomized_svd, svd_flip
    from ..preprocess import tfidf as _tfidf
    from .pca import make_engine_operator

    n, p = m.shape
    k_fit = int(n_components) + (1 if drop_first else 0)
    if not 1 <= k_fit <= min(n, p):
        raise ValueError(
            f"n_components={n_components} (+drop_first={drop_first}) out of range for "
            f"shape {m.shape}"
        )
    x = (_tfidf(m, scale_factor=scale_factor, log_tf=log_tf, log_idf=log_idf,
                log_tfidf=log_tfidf) if apply_tfidf else m)
    op = make_engine_operator(x, engine)
    res = randomized_svd(op, k_fit, n_oversamples=n_oversamples,
                         n_power_iterations=n_power_iterations, seed=seed)
    u, vt = svd_flip(res.u, res.vt)
    s = res.s
    scores = u * s[None, :]
    # TruncatedSVD-convention explained variance of the score columns
    col_mean = scores.mean(dim=0)
    exp_var = (scores * scores).mean(dim=0) - col_mean * col_mean
    total_var = float(np.sum(x.var_col().cpu().numpy().astype(np.float64))) * (
        (n - 1) / n if n > 1 else 1.0)
    ratio = exp_var.cpu().numpy().astype(np.float64) / max(total_var, 1e-300)

    scores, vt, s = (t.cpu().numpy() for t in (scores, vt, s))
    if drop_first:
        scores, vt, s, ratio = scores[:, 1:], vt[1:], s[1:], ratio[1:]
    if scale_embeddings:
        mu = scores.mean(axis=0, keepdims=True)
        sd = scores.std(axis=0, keepdims=True)
        scores = (scores - mu) / np.where(sd > 0, sd, 1.0)
    return LSIResult(scores=scores, components=vt, singular_values=s,
                     explained_variance_ratio=ratio)
