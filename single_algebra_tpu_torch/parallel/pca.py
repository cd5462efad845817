"""Sharded PCA: the fit of ``models/pca.py`` over a row-sharded operator.

Counterpart of ``single_algebra_tpu/parallel/pca.py``: rows (cells) are
sharded over the mesh, every sketch operand and p-wide statistic lives on
the home device, and each ``A^T @ ...`` product and column-stat pass ends
in one reduction. Both SVD methods run: the randomized sketch and the
Lanczos recurrences are sequences of ``mv`` / ``rmv`` products, so the
single-card fit (``models/pca.py::_fit_graph``) runs unchanged over the
sharded operator, with the single-card fit's sketch and start vector (its
``device`` is the home device).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..linalg.operators import DensifiedOperator, MaskedOperator
from ..models.pca import _fit_graph, _needs_lo
from ..sparse.matrix import SparseMatrix
from ..types import PowerIterationNormalizer, SVDMethod, precision_policy
from .sharded import (
    Mesh,
    ShardedDensified,
    ShardedSpMM,
    ShardedTiled,
    make_mesh,
    mesh_budget_bytes,
)

__all__ = [
    "ShardedPCAResult",
    "choose_sharded_engine",
    "sharded_pca_fit_transform",
]

_ENGINES = {"dense": ShardedDensified, "tiled": ShardedTiled, "sparse": ShardedSpMM}


def _on_cuda(mesh: Mesh) -> bool:
    return all(dev.type == "cuda" for dev in mesh.devices)


def choose_sharded_engine(m: SparseMatrix, mesh: Mesh) -> str:
    """Mesh analog of the single-card 'auto' ladder: 'dense' when the bf16
    densified payload fits the mesh's budget, else 'tiled' when the
    sharded tiled payload and its slabs' rmv forms fit, else 'sparse' (the
    gather engine). The budget is the sum of the DISTINCT devices' budgets
    (:func:`~.sharded.mesh_budget_bytes`). 'dense' and 'tiled' are
    float32 engines on CUDA meshes only, as in the single-card ladder.
    The Gram engine has its own entry point (``sharded_gram_pca``)."""

    if not _on_cuda(mesh) or m.dtype != torch.float32:
        return "sparse"
    budget = mesh_budget_bytes(mesh, DensifiedOperator.hbm_budget_bytes)
    # needs_lo doubles the byte requirement, so one check covers hi only
    if DensifiedOperator.fits(m.shape, budget_bytes=budget, needs_lo=_needs_lo(m),
                              device=mesh.home):
        return "dense"
    ndev = mesh.size
    if ShardedTiled.payload_bytes(m, ndev) + ShardedTiled.form_bytes(m, ndev) <= budget:
        return "tiled"
    return "sparse"


class ShardedPCAResult(NamedTuple):
    transformed: torch.Tensor  # [n, k] on the home device
    components: torch.Tensor  # [k, p] (or k x p_masked)
    explained_variance: torch.Tensor  # [k]
    mean: torch.Tensor  # [p]
    total_variance: float


@precision_policy()
def sharded_pca_fit_transform(
    x,
    n_components: int = 50,
    mesh: Mesh | None = None,
    svd_method: SVDMethod | None = None,
    center: bool = True,
    seed: int = 42,
    engine: str = "sparse",
    mask=None,
    lanczos_steps: int | None = None,
    tolerance: float | None = 1e-6,
    lanczos_block: int | None = None,
) -> ShardedPCAResult:
    """Centered PCA of a row-sharded sparse matrix (both SVD methods).

    ``x`` may be a ``SparseMatrix`` or scipy matrix (sharded here, over
    ``mesh`` or ``make_mesh()``'s cards) or a prebuilt
    :class:`ShardedSpMM` / :class:`ShardedDensified` /
    :class:`ShardedTiled`. ``engine``: 'dense' (bf16 GEMMs per slab),
    'tiled' (the tiled kernels per slab), 'sparse' (the gather engine) or
    'auto' (:func:`choose_sharded_engine`). The slab build is cached per
    (matrix, engine, mesh) in the matrix's operator cache. The Lanczos
    methods run on the RAW matrix, as the single-card fit does.

    ``mask`` (boolean, length p) restricts the features as
    ``MaskedSparsePCA`` does, through ``MaskedOperator`` on the home
    device's operands; ``mean`` stays full width, ``components`` is k x
    p_masked."""

    if svd_method is None:
        svd_method = SVDMethod.random(10, 7, PowerIterationNormalizer.QR)
    if isinstance(x, tuple(_ENGINES.values())):
        op = x
    else:
        mesh = mesh or make_mesh()
        if not isinstance(x, SparseMatrix):
            x = SparseMatrix.from_scipy(x, device=mesh.home)
        if engine == "auto":
            engine = choose_sharded_engine(x, mesh)
        if engine not in _ENGINES:
            raise ValueError(f"unknown sharded engine {engine!r}")
        key = ("sharded", engine, mesh)
        op = x._operator_cache.get(key)
        if op is None:
            op = x._operator_cache[key] = _ENGINES[engine].from_matrix(x, mesh)

    n, p = op.shape
    home = op.device
    stats = op.col_stats()
    s_np = stats[0].cpu().numpy().astype(np.float64)
    sq_np = stats[1].cpu().numpy().astype(np.float64)
    dt = stats[0].cpu().numpy().dtype
    mean_np = s_np / n

    idx_np = None
    fit_op = op
    if mask is not None:
        mask = np.asarray(mask, dtype=bool)
        if mask.shape[0] != p:
            raise ValueError(
                "The mask vector length and the number of features (columns)"
                " have to be the same!"
            )
        idx_np = np.where(mask)[0]
        fit_op = MaskedOperator(op, torch.as_tensor(idx_np, device=home))

    total_var = None
    if center:
        var_all = (sq_np - mean_np * s_np) / max(n - 1, 1)
        total_var = float(var_all.sum() if idx_np is None else var_all[idx_np].sum())
    mean_full = mean_np if center else np.zeros(p)
    mean = torch.as_tensor(mean_full.astype(dt), device=home)
    fit_mean = mean if idx_np is None else torch.as_tensor(mean_full[idx_np].astype(dt),
                                                           device=home)

    s_dev, vt, T = _fit_graph(
        fit_op, fit_mean, seed, k=n_components, method=svd_method, center=center,
        steps=lanczos_steps, want_transform=True, tol=tolerance, lanczos_block=lanczos_block,
    )
    ev_np = s_dev.cpu().numpy().astype(np.float64) ** 2 / max(n - 1, 1)
    if not center:
        total_var = float(ev_np.sum())
    return ShardedPCAResult(T, vt, torch.as_tensor(ev_np.astype(dt), device=home), mean,
                            total_var)
