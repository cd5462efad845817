"""Diffusion-based expression imputation (the MAGIC role).

Counterpart of ``single_algebra_tpu/imputation.py`` (van Dijk et al.
2018): ``X_imputed = M^t X`` with M the row-normalized fuzzy kNN
connectivities plus self-loops. Each diffusion step multiplies a gene
block by M on the device: while the ``[n, n]`` hi/lo bf16 form of M fits
the card (1.2 x ``DensifiedOperator``'s budget) as the densified
operator's precise product (dense GEMMs), otherwise as the sparse
product. Gene blocks of a ``SparseMatrix`` are densified on the device
from its gene-major layout (``ell_scatter_densify``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .types import precision_policy

__all__ = ["magic"]


@precision_policy()
def magic(
    X,
    *,
    embedding: Optional[np.ndarray] = None,
    n_neighbors: int = 15,
    t: int = 3,
    self_weight: float = 1.0,
    block: int = 1024,
    device_out: bool = False,
    device="cuda",
):
    """Impute / denoise expression by graph diffusion.

    ``X``: ``SparseMatrix`` (its device runs the diffusion) or dense
    [n, p] (on ``device``), typically log-normalized. ``embedding``:
    [n, d] coordinates the kNN graph is built from (a PCA embedding);
    defaults to the rows of X. ``t``: diffusion steps. ``self_weight``:
    the self-loop's weight before row normalization. Returns a dense
    [n, p] float32 array: host numpy, or with ``device_out`` the device
    tensor.
    """

    import scipy.sparse as sp

    from .linalg.operators import DensifiedOperator
    from .neighbors import connectivities
    from .ops.spmm import ell_scatter_densify
    from .sparse.matrix import SparseMatrix

    if t < 1:
        raise ValueError(f"t={t} must be >= 1")
    is_sparse = isinstance(X, SparseMatrix)
    if is_sparse:
        device = X.device
    elif isinstance(X, torch.Tensor):
        device = X.device
    n, p = X.shape

    if embedding is None:
        embedding = X.to_dense() if is_sparse else X
    if isinstance(embedding, torch.Tensor):
        embedding = embedding.float().to(device)
    else:
        embedding = torch.as_tensor(np.asarray(embedding, np.float32), device=device)
    if embedding.shape[0] != n:
        raise ValueError(f"embedding rows ({embedding.shape[0]}) != matrix rows ({n})")

    W = connectivities(embedding, n_neighbors=n_neighbors, device=device).tolil()
    W.setdiag(self_weight)
    W = W.tocsr()
    rs = np.asarray(W.sum(axis=1)).ravel()
    M = sp.diags(1.0 / np.maximum(rs, 1e-30)) @ W  # row-stochastic
    Md = SparseMatrix.from_scipy(M.astype(np.float32).tocsr(), device=device)

    # a kNN graph against a WIDE dense operand is the gather engine's
    # worst case; while the [n, n] hi/lo form fits, each step is the
    # densified operator's precise product (dense GEMMs), densified on
    # the device from the graph's CSR
    budget = int(DensifiedOperator.hbm_budget_bytes(Md.device) * 1.2)
    if DensifiedOperator.fits((n, n), budget_bytes=budget, needs_lo=True, device=Md.device):
        step = DensifiedOperator.from_matrix(Md, device=True).mv_precise
    else:
        step = Md.matmul_dense

    mc = X._layout_for("col") if is_sparse else None  # gene-major ELL
    if not is_sparse and not isinstance(X, torch.Tensor):
        X = torch.as_tensor(np.asarray(X, np.float32), device=device)
    out = torch.empty((n, p), dtype=torch.float32, device=device)
    for j0 in range(0, p, block):
        j1 = min(j0 + block, p)
        if is_sparse:
            blk = ell_scatter_densify(mc.ell_data[j0:j1], mc.ell_ids[j0:j1],
                                      mc.row_nnz[j0:j1], n).T.float()
        else:
            blk = X[:, j0:j1].float()
        for _ in range(t):
            blk = step(blk)
        out[:, j0:j1] = blk
    return out if device_out else out.cpu().numpy()
