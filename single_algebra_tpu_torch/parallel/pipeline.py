"""Mesh-sharded scRNA pipeline stages over the row-sharded gather engine.

Counterpart of ``single_algebra_tpu/parallel/pipeline.py``: at north-star
scale the whole pipeline shards, not just the PCA. Every stage is the row
slab decomposition of :class:`~.sharded.ShardedSpMM`, whose slab ``d`` is
a ``SparseOperator`` on ``mesh.devices[d]`` holding the slab's row ELL
(ids: global columns) and its slab-local transposed ELL (ids: slab rows):

* per-cell statistics are slab-local reductions over the row layout,
  gathered on the home device (no reduction);
* per-gene statistics are slab-local reductions over the transposed
  layout, added on the home device in slab order (``_psum``, the JAX
  ``psum``);
* grouped (per-cluster) statistics are scatter-adds of each slab's
  transposed layout into its cells' groups, float64 as in the port's
  ``de``, added in slab order.

Value updates (normalize, log1p, scaling) are functional payload maps:
:func:`mesh_map_stored` rewrites both layouts of every slab and returns a
NEW operator (the mesh analog of ``SparseMatrix.map_stored``). Padding
slots hold ``v = 0`` and must map to 0, as every stage here does (``x *
g``, ``log1p``, ``expm1``). ``log1p`` / ``expm1`` are ``torch.log1p`` /
``torch.expm1`` (the port's decision for ``precise_math``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..linalg.operators import SparseOperator
from ..ops import stats as _st
from ..types import precision_policy
from .sharded import ShardedSpMM, _psum

__all__ = [
    "mesh_map_stored",
    "mesh_row_stats",
    "mesh_sum_row_masked",
    "mesh_col_moments",
    "mesh_qc_metrics",
    "mesh_normalize_total",
    "mesh_log1p",
    "mesh_scale",
    "mesh_highly_variable_genes",
    "mesh_grouped_moments",
    "mesh_rank_genes_groups",
]


def _slabs(op: ShardedSpMM):
    """``(d, device, slab operator, transposed row counts)`` per slab."""

    return zip(range(op.ndev), op.mesh.devices, op.slabs, op.tr_nnz)


def _per_device(a: np.ndarray, op: ShardedSpMM, dtype) -> dict:
    """Host array ``a`` on each distinct device of the mesh."""

    t = torch.from_numpy(np.ascontiguousarray(a))
    return {dev: t.to(device=dev, dtype=dtype) for dev in op.mesh.distinct}


# ----------------------------------------------------------------------
# functional payload maps
# ----------------------------------------------------------------------


def _map_slab(op: ShardedSpMM, d: int, s: SparseOperator, tn: torch.Tensor, fn):
    """Slab ``d`` with ``fn(values, global_row_ids, global_col_ids)``
    applied to both layouts."""

    dev = s.row_data.device
    rs = op.rs
    # row layout: positions are global rows, ids global columns
    gr = (d * rs + torch.arange(s.row_data.shape[0], device=dev))[:, None].expand_as(s.row_data)
    rd = fn(s.row_data, gr, s.row_ids.long())
    # transposed layout: ids are slab-LOCAL rows, positions global columns
    gr_t = d * rs + s.col_ids.long()
    gc = torch.arange(s.col_data.shape[0], device=dev)[:, None].expand_as(s.col_data)
    td = fn(s.col_data, gr_t, gc)
    # re-mask the transposed padding slots: a caller's fn that breaks the
    # fn(0) -> 0 contract would otherwise corrupt padded gene slots feeding
    # every per-gene reduction
    td = torch.where(_st.valid_mask(s.col_ids, tn), td, torch.zeros_like(td))
    return SparseOperator(rd, s.row_ids, td, s.col_ids, s.shape)


@precision_policy()
def mesh_map_stored(op: ShardedSpMM, fn) -> ShardedSpMM:
    """New operator with ``fn(v, row, col)`` applied to stored values
    (tensors; ``row`` / ``col`` are global int64 ids).

    ``fn`` must map 0 -> 0 for all (row, col): padding slots carry explicit
    zeros in both layouts (the contract of the single-device
    ``map_stored``, which only ever touches stored entries). The
    transposed layout, the one feeding every per-gene reduction, is
    re-masked through ``tr_nnz`` regardless; the row layout has no per-row
    counts, so set ``SINGLE_ALGEBRA_TPU_DEBUG=1`` to probe the contract
    with a zero input (opt in, as in the JAX package)."""

    if os.environ.get("SINGLE_ALGEBRA_TPU_DEBUG"):
        _check_zero_preserving(fn, op.shape, op.dtype, op.mesh.home)
    slabs = tuple(_map_slab(op, d, s, tn, fn) for d, _, s, tn in _slabs(op))
    return dataclasses.replace(op, slabs=slabs)


def _check_zero_preserving(fn, shape, dtype, device) -> None:
    """Probe ``fn`` with zero values at the index corners; raises when the
    result is non-zero (padding slots would be corrupted)."""

    n, p = shape
    v = torch.zeros(4, dtype=dtype, device=device)
    r = torch.tensor([0, 0, n - 1, n - 1], device=device)
    c = torch.tensor([0, p - 1, 0, p - 1], device=device)
    out = fn(v, r, c)
    if tuple(out.shape) != (4,) or bool((out != 0).any()):
        raise ValueError(
            "mesh_map_stored: fn must map zero values to zero (padding slots "
            f"hold v=0); got fn(0, r, c) = {out.cpu().numpy()!r}. Non-zero-"
            "preserving maps would corrupt padded slots.")


def _mesh_log1p_fn(v, r, c):
    return torch.log1p(v)


def mesh_log1p(op: ShardedSpMM) -> ShardedSpMM:
    """``ln(1 + x)`` on stored values (implicit zeros stay zero), mesh
    edition."""

    return mesh_map_stored(op, _mesh_log1p_fn)


# ----------------------------------------------------------------------
# statistics
# ----------------------------------------------------------------------


@precision_policy()
def mesh_row_stats(op: ShardedSpMM) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, nonzero count) per cell on the home device: slab-local row
    reductions, no reduction over the mesh. Counts are of nonzero VALUES
    (padding slots are zero)."""

    home, n = op.mesh.home, op.shape[0]
    sums, nzs = [], []
    for _, _, s, _ in _slabs(op):
        sums.append(s.row_data.sum(dim=1).to(home))
        nzs.append((s.row_data != 0).sum(dim=1, dtype=torch.int32).to(home))
    return torch.cat(sums)[:n], torch.cat(nzs)[:n]


@precision_policy()
def mesh_sum_row_masked(op: ShardedSpMM, col_mask) -> torch.Tensor:
    """Per-cell sums restricted to a boolean gene mask (QC's
    ``total_counts_<name>``): one slab-local gather-weighted reduction."""

    p = op.shape[1]
    col_mask = np.asarray(col_mask)
    if col_mask.dtype != bool or col_mask.shape != (p,):
        raise ValueError(f"col_mask must be a bool mask of length {p}")
    mask_f = _per_device(col_mask, op, op.dtype)
    home = op.mesh.home
    parts = [(s.row_data * mask_f[dev][s.row_ids.long()]).sum(dim=1).to(home)
             for _, dev, s, _ in _slabs(op)]
    return torch.cat(parts)[: op.shape[0]]


@precision_policy()
def mesh_col_moments(op: ShardedSpMM, *, expm1: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Per-gene (mean, Bessel var over all n rows incl. implicit zeros),
    the ``var_col`` statistic; one reduction each. ``expm1=True`` de-logs
    stored values on the fly (the 'seurat' HVG flavor on log1p data;
    ``expm1(0) = 0`` keeps padding exact)."""

    def terms():
        for _, _, s, _ in _slabs(op):
            x = torch.expm1(s.col_data) if expm1 else s.col_data
            yield torch.stack([x.sum(dim=1), (x * x).sum(dim=1)])

    n, p = op.shape
    tot = _psum(terms(), op.mesh.home).cpu().numpy().astype(np.float64)[:, :p]
    mean = tot[0] / n
    var = (tot[1] / n - mean * mean) * (n / max(n - 1.0, 1.0))
    return mean, np.maximum(var, 0.0)


# ----------------------------------------------------------------------
# pipeline stages
# ----------------------------------------------------------------------


@precision_policy()
def mesh_qc_metrics(
    op: ShardedSpMM,
    *,
    qc_vars: Optional[Mapping[str, np.ndarray]] = None,
    log1p: bool = True,
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Mesh edition of :func:`~single_algebra_tpu_torch.qc.calculate_qc_metrics`
    (same obs / var keys): per-cell stats are slab-local, per-gene stats
    one reduction, each ``qc_vars`` mask one slab-local pass."""

    n, p = op.shape
    if n < 1 or p < 1:
        raise ValueError(f"Matrix has empty shape {op.shape}")

    obs: Dict[str, np.ndarray] = {}
    var: Dict[str, np.ndarray] = {}

    rsum, rnz = mesh_row_stats(op)
    obs["n_genes_by_counts"] = rnz.cpu().numpy()
    total = rsum.cpu().numpy().astype(np.float64)
    obs["total_counts"] = total

    csum, _, ccnt = op.col_stats()
    var["n_cells_by_counts"] = ccnt.cpu().numpy()
    gtotal = csum.cpu().numpy().astype(np.float64)
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
        sub = mesh_sum_row_masked(op, mask).cpu().numpy().astype(np.float64)
        obs[f"total_counts_{name}"] = sub
        obs[f"pct_counts_{name}"] = 100.0 * sub / denom
        if log1p:
            obs[f"log1p_total_counts_{name}"] = np.log1p(sub)

    return obs, var


def mesh_normalize_total(
    op: ShardedSpMM, *, target_sum: Optional[float] = None
) -> Tuple[ShardedSpMM, np.ndarray]:
    """Total-count normalize rows over the mesh (scanpy
    ``pp.normalize_total``; ``target_sum=None`` = median of per-cell
    counts). Zero-sum cells are left untouched. Returns ``(op',
    size_factors)``."""

    sums = mesh_row_stats(op)[0].cpu().numpy().astype(np.float64)
    if target_sum is None:
        pos = sums[sums > 0]
        target_sum = float(np.median(pos)) if pos.size else 1.0
    fac = np.where(sums > 0, target_sum / np.where(sums > 0, sums, 1.0), 1.0)
    fac_pad = np.zeros(op.n_padded, np.float64)
    fac_pad[: len(sums)] = fac
    fac_dev = _per_device(fac_pad, op, op.dtype)
    out = mesh_map_stored(op, lambda v, r, c: v * fac_dev[v.device][r])
    return out, sums / target_sum


def mesh_scale(
    op: ShardedSpMM,
    *,
    zero_center: bool = False,
    max_value: Optional[float] = None,
) -> ShardedSpMM:
    """Unit-variance gene scaling over the mesh (scanpy ``pp.scale`` with
    ``zero_center=False``, the sparsity-preserving variant; the centered
    variant densifies ``[n, p]``, which at mesh scale is what the PCA
    engines' implicit centering avoids, so it is refused). Zero-variance
    genes are left unscaled; ``max_value`` upper-clips after scaling."""

    if zero_center:
        raise ValueError(
            "zero_center=True densifies [n, p]; at mesh scale use the "
            "PCA engines' implicit centering instead (center=True)")
    _, var = mesh_col_moments(op)
    std = np.sqrt(np.maximum(var, 0.0))
    inv = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 1.0)
    inv_pad = np.zeros(op.slabs[0].col_data.shape[0], np.float64)
    inv_pad[: len(inv)] = inv
    inv_dev = _per_device(inv_pad, op, op.dtype)

    def fn(v, r, c):
        new = v * inv_dev[v.device][c]
        if max_value is not None:
            new = torch.clamp(new, max=max_value)
        return new

    return mesh_map_stored(op, fn)


def mesh_highly_variable_genes(
    op: ShardedSpMM,
    *,
    n_top_genes: Optional[int] = None,
    flavor: str = "seurat",
    assume_logged: Optional[bool] = None,
    n_bins: int = 20,
    min_mean: float = 0.0125,
    max_mean: float = 3.0,
    min_disp: float = 0.5,
    max_disp: float = float("inf"),
):
    """HVG selection over the mesh: one reduction for the column moments,
    then the shared p-length host selection
    (:func:`~single_algebra_tpu_torch.feature_selection.highly_variable_genes_from_moments`).
    'seurat' de-logs on the fly (``assume_logged`` defaults to True for
    'seurat', False for 'cell_ranger': the single-device defaults)."""

    from ..feature_selection import highly_variable_genes_from_moments

    if flavor not in ("seurat", "cell_ranger"):
        raise ValueError(
            f"flavor {flavor!r} not supported on the mesh (seurat_v3 / "
            "pearson_residuals need per-entry passes — single-device only)")
    if assume_logged is None:
        assume_logged = flavor == "seurat"
    mean, var = mesh_col_moments(op, expm1=bool(assume_logged))
    return highly_variable_genes_from_moments(
        mean, var, n_top_genes=n_top_genes, flavor=flavor, n_bins=n_bins,
        min_mean=min_mean, max_mean=max_mean, min_disp=min_disp, max_disp=max_disp)


# ----------------------------------------------------------------------
# grouped (per-cluster) statistics + DE
# ----------------------------------------------------------------------


class _MeshDEView:
    """Stand-in for a ``SparseMatrix`` inside
    :func:`~single_algebra_tpu_torch.de.rank_genes_groups`: ``shape``,
    ``_batch_codes``, the grouped sums of ``de``'s moment seam and the
    grouped counts of ``pts``: everything the t-test path touches."""

    def __init__(self, op: ShardedSpMM):
        self.op = op
        self.shape = op.shape

    def _batch_codes(self, batches: Sequence, expected: int, what: str):
        from ..sparse.matrix import SparseMatrix

        return SparseMatrix._batch_codes(self, batches, expected, what)

    def _slab_codes(self, codes: np.ndarray) -> list:
        """Each slab's cells' group codes on its device (padding rows take
        group 0: they hold no stored entry)."""

        op = self.op
        pad = np.zeros(op.n_padded, np.int64)
        pad[: len(codes)] = codes
        return [torch.from_numpy(pad[d * op.rs:(d + 1) * op.rs]).to(dev)
                for d, dev in enumerate(op.mesh.devices)]

    @precision_policy()
    def _grouped_sums(self, codes: np.ndarray, n_groups: int):
        """float64 ``[p, G]`` per-(gene, group) sums and sums of squares:
        ``de._grouped_sums`` on each slab's transposed layout, added in
        slab order."""

        from ..de import _grouped_sums

        op, p = self.op, self.op.shape[1]
        parts = [torch.stack(_grouped_sums(s.col_data, s.col_ids, c, n_groups, p))
                 for s, c in zip(op.slabs, self._slab_codes(codes))]
        tot = _psum(iter(parts), op.mesh.home)
        return tot[0], tot[1]

    @precision_policy()
    def _batch_spmm(self, axis: str, codes: np.ndarray, transform: str) -> torch.Tensor:
        """``[p, G]`` grouped sums of the transposed layout, in the matrix
        dtype (``transform`` 'sum', 'sumsq' or 'count'), added in slab
        order: ``SparseMatrix._batch_spmm(axis='col')`` over the mesh."""

        from ..ops.spmm import ell_onehot_spmm

        if axis != "col":
            raise ValueError(
                "mesh grouped stats support row-grouped column outputs only (axis='col')")
        op, p = self.op, self.op.shape[1]
        nb = int(codes.max()) + 1 if len(codes) else 1

        def parts():
            for (_, _, s, tn), c in zip(_slabs(op), self._slab_codes(codes)):
                if transform == "sum":
                    data = s.col_data
                elif transform == "sumsq":
                    data = s.col_data * s.col_data
                elif transform == "count":
                    data = _st.valid_mask(s.col_ids, tn).to(s.col_data.dtype)
                else:
                    raise ValueError(transform)
                yield ell_onehot_spmm(data, s.col_ids, c, nb)

        return _psum(parts(), op.mesh.home)[:p]


def mesh_grouped_moments(op: ShardedSpMM, codes: np.ndarray, n_groups: int):
    """Per-group per-gene (size, mean, Bessel var incl. implicit zeros)
    over the mesh: ``de._full_moments`` through the mesh view (float64
    sums, one reduction)."""

    from ..de import _full_moments

    return _full_moments(_MeshDEView(op), np.asarray(codes), n_groups)


def mesh_rank_genes_groups(
    op: ShardedSpMM,
    labels: Sequence,
    *,
    method: str = "t-test",
    groups="all",
    reference: str = "rest",
    var_names: Optional[Sequence] = None,
    n_genes: Optional[int] = None,
    log1p_input: bool = True,
    pts: bool = False,
):
    """Mesh edition of :func:`~single_algebra_tpu_torch.de.rank_genes_groups`
    for the grouped-moment methods ('t-test' / 't-test_overestim_var'):
    the moments come from the slabs' grouped sums, the p-length Welch / BH
    assembly is shared host code. The rank-based and iterative methods
    (wilcoxon / logreg) need per-entry passes and stay single-device."""

    from ..de import rank_genes_groups

    if method not in ("t-test", "t-test_overestim_var"):
        raise ValueError(
            f"method {method!r} is not supported on the mesh (grouped-"
            "moment t-tests only; run wilcoxon/logreg single-device)")
    return rank_genes_groups(
        _MeshDEView(op), labels, method=method, groups=groups, reference=reference,
        var_names=var_names, n_genes=n_genes, log1p_input=log1p_input, pts=pts)
