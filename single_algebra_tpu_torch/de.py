"""Differential expression: ``rank_genes_groups`` on the device.

Counterpart of ``single_algebra_tpu/de.py`` (scanpy's
``tl.rank_genes_groups``):

* **t-test / t-test_overestim_var**: per-group means and variances
  (zeros included) from the grouped one-hot sums of the gene-major
  layout, one scatter pass per moment for all groups, in gene blocks,
  accumulated in float64.
* **wilcoxon**: rank-sum z-scores with the exact tie correction. Per
  gene block, the STORED entries are ranked: one stable sort of the
  block's slots, tie-run bounds by ``cummax`` / ``cummin`` scans,
  scattered back by the carried slot index; the member zeros (implicit
  and stored) are one analytic tie group. The ranks are half-integers,
  and the port adds them in float64, where every partial sum is exact:
  the per-(gene, group) sums are then the same bits in any order (the
  card's scatter-adds run as atomics) and exact at 10^6 cells, where
  float32 sums of ranks near 10^6 are not. The JAX package keeps the
  matrix dtype; at the tests' sizes its float32 sums are exact too.
* **logreg**: multinomial logistic regression, 300 Nesterov steps, two
  products a step: the gather engine (``ell_spmm``, the JAX package's)
  on the CPU, float32 GEMMs of the matrix densified on a card where it
  fits; the start ``W0`` is drawn from a ``torch.Generator``.

Only p-length statistics reach the host; p-values and Benjamini-Hochberg
are host float64.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .types import precision_policy

__all__ = ["rank_genes_groups", "DEResult", "marker_gene_overlap"]


@dataclasses.dataclass
class DEResult:
    """Per-group differential expression tables.

    Every field maps group name -> array of length ``n_genes_ranked``,
    sorted by decreasing score (scanpy's layout, minus the recarray).
    """

    names: Dict  # group -> gene names (or int indices)
    scores: Dict  # group -> test statistic (t or z)
    pvals: Dict
    pvals_adj: Dict
    logfoldchanges: Dict  # log2 fold change, scanpy semantics
    method: str
    reference: str
    pts: Optional[Dict] = None  # group -> fraction expressing (pts=True)
    pts_rest: Optional[Dict] = None

    def group(self, name) -> Dict[str, np.ndarray]:
        """One group's table as a dict of columns."""

        out = {
            "names": self.names[name],
            "scores": self.scores[name],
            "pvals": self.pvals[name],
            "pvals_adj": self.pvals_adj[name],
            "logfoldchanges": self.logfoldchanges[name],
        }
        if self.pts is not None:
            out["pts"] = self.pts[name]
            out["pts_rest"] = self.pts_rest[name]
        return out

    def filter(
        self,
        *,
        min_fold_change: float = 1.0,
        min_in_group_fraction: float = 0.25,
        max_out_group_fraction: float = 0.5,
    ) -> "DEResult":
        """Keep markers passing effect-size / expression cutoffs (scanpy
        ``tl.filter_rank_genes_groups``); needs ``pts=True`` at rank time.
        ``min_fold_change`` is the RAW fold change."""

        if self.pts is None:
            raise ValueError("filter() needs pts: rerun rank_genes_groups(pts=True)")
        if min_fold_change <= 0:
            raise ValueError("min_fold_change must be positive")
        fields = ("names", "scores", "pvals", "pvals_adj", "logfoldchanges", "pts",
                  "pts_rest")
        out = {f: {} for f in fields}
        for g in self.names:
            keep = (
                (self.logfoldchanges[g] >= np.log2(min_fold_change))
                & (self.pts[g] >= min_in_group_fraction)
                & (self.pts_rest[g] <= max_out_group_fraction)
            )
            for f in fields:
                out[f][g] = getattr(self, f)[g][keep]
        return DEResult(
            out["names"], out["scores"], out["pvals"], out["pvals_adj"],
            out["logfoldchanges"], self.method, self.reference, out["pts"], out["pts_rest"],
        )


def marker_gene_overlap(
    de: "DEResult",
    reference_markers: Dict,
    *,
    top_n: Optional[int] = 100,
    method: str = "overlap_count",
) -> Dict:
    """Score each DE group's top markers against known marker sets
    (scanpy ``tl.marker_gene_overlap``). ``method``: 'overlap_count',
    'overlap_coef' (|A∩B| / min(|A|, |B|)) or 'jaccard'. Returns
    ``{cell_type: {group: score}}``."""

    if method not in ("overlap_count", "overlap_coef", "jaccard"):
        raise ValueError(f"unknown method {method!r}")
    if not reference_markers:
        raise ValueError("reference_markers is empty")
    groups = {
        g: set(np.asarray(v[:top_n] if top_n is not None else v).tolist())
        for g, v in de.names.items()
    }
    out: Dict = {}
    for ct, markers in reference_markers.items():
        ref = set(np.asarray(list(markers)).tolist())
        if not ref:
            raise ValueError(f"marker set for {ct!r} is empty")
        row = {}
        for g, sel in groups.items():
            inter = len(sel & ref)
            if method == "overlap_count":
                row[g] = float(inter)
            elif method == "overlap_coef":
                row[g] = inter / max(min(len(sel), len(ref)), 1)
            else:
                row[g] = inter / max(len(sel | ref), 1)
        out[ct] = row
    return out


# ----------------------------------------------------------------------
# shared host helpers
# ----------------------------------------------------------------------


def _bh_adjust(pvals: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg FDR over one group's p-vector."""

    p = np.asarray(pvals, np.float64)
    m = p.size
    order = np.argsort(p)
    ranked = p[order] * m / np.arange(1, m + 1)
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(m, np.float64)
    out[order] = np.minimum(ranked, 1.0)
    return out


def _log2_fold_change(mean_g, mean_rest, expm1: bool) -> np.ndarray:
    """scanpy's logfoldchanges: log2((expm1(m1)+1e-9)/(expm1(m2)+1e-9));
    ``expm1=False`` skips the de-logging for raw input."""

    a, b = np.asarray(mean_g, np.float64), np.asarray(mean_rest, np.float64)
    if expm1:
        a, b = np.expm1(a), np.expm1(b)
    return np.log2((a + 1e-9) / (b + 1e-9))


# slots of one [genes, W] block of the grouped sums
_MOMENT_BLOCK = 1 << 26


def _grouped_sums(ell_data, ell_ids, codes_t: torch.Tensor, n_groups: int, p: int):
    """Per-(gene, group) sums and sums of squares of a gene-major ELL
    payload (``ell_ids`` index ``codes_t``), float64 ``[p, G]`` tensors:
    the JAX package's two one-hot products (``_batch_spmm`` 'sum' /
    'sumsq'), as scatter-adds over gene blocks of the payload."""

    W = max(ell_data.shape[1], 1)
    step = max(1, _MOMENT_BLOCK // W)
    dev = ell_data.device
    sums = torch.zeros((p, n_groups), dtype=torch.float64, device=dev)
    sumsq = torch.zeros_like(sums)
    for j0 in range(0, p, step):
        j1 = min(j0 + step, p)
        d = ell_data[j0:j1].double()
        bins = codes_t[ell_ids[j0:j1].long()]
        sums[j0:j1].scatter_add_(1, bins, d)
        sumsq[j0:j1].scatter_add_(1, bins, d * d)
    return sums, sumsq


def _full_moments(m, codes: np.ndarray, n_groups: int):
    """Per-group per-gene (size, mean, Bessel var) with zeros included:
    float64 host arrays ``[G]``, ``[p, G]``, ``[p, G]``.

    The seam of the mesh: a matrix-like ``m`` with a ``_grouped_sums(codes,
    n_groups)`` method (``parallel.pipeline``'s view of a row-sharded
    operator) supplies the float64 ``[p, G]`` sums and sums of squares
    itself; a ``SparseMatrix`` reduces its gene-major layout here."""

    own = getattr(m, "_grouped_sums", None)
    if own is not None:
        s, sq = own(codes, n_groups)
    else:
        mc = m._layout_for("col")
        codes_t = torch.as_tensor(codes, dtype=torch.int64, device=m.device)
        s, sq = _grouped_sums(mc.ell_data, mc.ell_ids, codes_t, n_groups, m.ncols)
    sums, sumsq = s.cpu().numpy(), sq.cpu().numpy()
    sizes = np.bincount(codes, minlength=n_groups).astype(np.float64)
    mean = sums / np.maximum(sizes, 1.0)[None, :]
    var = (sumsq - sums * mean) / np.maximum(sizes - 1.0, 1.0)[None, :]
    return sizes, mean, np.maximum(var, 0.0)


def _welch(m1, v1, n1, m2, v2, n2, overestim: bool):
    """Welch t statistic + two-sided p (t distribution, WS dof).
    ``overestim`` charges the rest's variance at the GROUP's size
    (scanpy's t-test_overestim_var)."""

    from scipy import stats

    d1 = v1 / n1
    d2 = v2 / (n1 if overestim else n2)
    denom = np.sqrt(d1 + d2)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(denom > 0, (m1 - m2) / np.where(denom > 0, denom, 1.0), 0.0)
        dof_num = (d1 + d2) ** 2
        dof_den = d1 * d1 / max(n1 - 1.0, 1.0) + d2 * d2 / max(n2 - 1.0, 1.0)
        dof = np.where(dof_den > 0, dof_num / np.where(dof_den > 0, dof_den, 1.0), 1.0)
    pv = 2.0 * stats.t.sf(np.abs(t), np.maximum(dof, 1.0))
    return t, pv


# ----------------------------------------------------------------------
# wilcoxon
# ----------------------------------------------------------------------


def _rank_block_sparse(ed, ei, nz, member, col_map, n1, n_member, n_out: int,
                       acc=torch.float64):
    """Tie-averaged rank sums per (gene, group) for one gene block, over
    the STORED entries only.

    ``ed``/``ei``/``nz``: gene-major ELL block ``[B, W]`` and the stored
    counts; ``member`` ``[n]`` bool; ``col_map`` ``[n]`` output column per
    cell (``n_out`` = dropped); ``n1`` ``[n_out]`` member counts per
    group; ``n_member`` the member count. The member zeros, implicit and
    stored, form one analytic tie group, so the sort runs over the W
    stored slots, not the n cells; negative values rank below it.

    Returns ``(ranksum [B, n_out], tie_term [B])`` in ``acc``, with
    tie_term = sum over tie groups of t^3 - t among members. Positions,
    ranks and sums are carried in ``acc`` (float64: exact; see the
    module docstring)."""

    B, W = ed.shape
    dev = ed.device
    jpos = torch.arange(W, device=dev)[None, :].expand(B, W)
    valid = jpos < nz[:, None]
    mem_slot = valid & member[ei.long()]
    x = torch.where(mem_slot, ed, torch.full_like(ed, float("inf")))

    # tie-run bounds from ONE stable sort + cumulative scans, scattered
    # back by the carried slot index
    s, si = torch.sort(x, dim=1, stable=True)
    diff = s[:, 1:] != s[:, :-1]
    ones = torch.ones((B, 1), dtype=torch.bool, device=dev)
    newrun = torch.cat([ones, diff], dim=1)
    endrun = torch.cat([diff, ones], dim=1)
    left_sorted = torch.cummax(torch.where(newrun, jpos, 0), dim=1).values
    right_sorted = torch.cummin(
        torch.where(endrun, jpos + 1, W).flip(1), dim=1).values.flip(1)
    left_s = torch.zeros((B, W), dtype=acc, device=dev).scatter_(1, si, left_sorted.to(acc))
    right_s = torch.zeros((B, W), dtype=acc, device=dev).scatter_(1, si, right_sorted.to(acc))

    s_cnt = mem_slot.sum(dim=1)
    z_impl = (int(n_member) - s_cnt).to(acc)  # implicit member zeros
    left = left_s + z_impl[:, None] * (x > 0)
    right = right_s + z_impl[:, None] * (x >= 0)
    zero = torch.zeros((), dtype=acc, device=dev)
    ranks = torch.where(mem_slot, 0.5 * (left + right + 1.0), zero)

    # the zero tie group (stored member 0.0s merge with the implicit
    # zeros): bounds are mask counts, x being +inf on non-member slots
    l0 = (x < 0).sum(dim=1).to(acc)
    r0 = (x <= 0).sum(dim=1).to(acc) + z_impl
    rank0 = 0.5 * (l0 + r0 + 1.0)
    t0 = r0 - l0

    t = right - left
    tie = torch.where(mem_slot, t * t - 1.0, zero).sum(dim=1) + z_impl * (t0 * t0 - 1.0)

    # per-(gene, group) sums; column n_out collects the dropped slots
    tgt = torch.where(mem_slot, col_map[ei.long()], n_out)
    ranksum_stored = torch.zeros((B, n_out + 1), dtype=acc, device=dev).scatter_add_(
        1, tgt, ranks)[:, :n_out]
    cnt = torch.zeros((B, n_out + 1), dtype=acc, device=dev).scatter_add_(
        1, tgt, mem_slot.to(acc))[:, :n_out]
    ranksum = ranksum_stored + rank0[:, None] * (n1.to(acc)[None, :] - cnt)
    return ranksum, tie


def _wilcoxon_block(W: int) -> int:
    """Genes per rank block: the ~8 ``[block, W]`` work buffers within
    ~2 GB (at least 16, at most 4096), W being the widest gene."""

    return int(max(16, min(4096, (2 * 1024**3) // (8 * 4 * max(W, 1)))))


def _wilcoxon_plans(codes: np.ndarray, group_ids: Sequence[int], ref_id: Optional[int],
                    n_groups: int):
    """``(member mask, output column per cell, output columns)`` per
    ranking: one over all cells against the rest, or one per (group,
    reference) pair."""

    n = len(codes)
    if ref_id is None:
        col_of = np.full(n_groups, len(group_ids), np.int64)
        for j, g in enumerate(group_ids):
            col_of[g] = j
        return [(np.ones(n, bool), col_of[codes], list(range(len(group_ids))))]
    return [((codes == g) | (codes == ref_id), np.where(codes == g, 0, 1).astype(np.int64), [j])
            for j, g in enumerate(group_ids)]


def _wilcoxon_scores(
    m,
    codes: np.ndarray,
    group_ids: Sequence[int],
    ref_id: Optional[int],
    n_groups: int,
    *,
    tie_correct: bool,
    block: Optional[int],
):
    """z-scores and p-values ``[p, len(group_ids)]``, blocked over genes."""

    from scipy import stats

    n, p = m.shape
    mc = m._layout_for("col")  # gene-major ELL
    W = mc.ell_width
    if block is None:
        block = _wilcoxon_block(W)
    dev = m.device
    z = np.zeros((p, len(group_ids)), np.float64)
    for mask, cmap, outcols in _wilcoxon_plans(codes, group_ids, ref_id, n_groups):
        mask_d = torch.as_tensor(mask, device=dev)
        cmap_d = torch.as_tensor(cmap, device=dev)
        n_sub = float(mask.sum())
        n1 = np.asarray([float(((codes == group_ids[c]) & mask).sum()) for c in outcols])
        n2 = n_sub - n1
        n1_d = torch.as_tensor(n1, dtype=torch.float64, device=dev)
        rsums = np.zeros((p, len(outcols)), np.float64)
        ties = np.zeros(p, np.float64)
        for j0 in range(0, p, block):
            j1 = min(j0 + block, p)
            rs, tt = _rank_block_sparse(
                mc.ell_data[j0:j1], mc.ell_ids[j0:j1], mc.row_nnz[j0:j1],
                mask_d, cmap_d, n1_d, n_sub, len(outcols),
            )
            rsums[j0:j1] = rs.cpu().numpy()
            ties[j0:j1] = tt.cpu().numpy()
        expected = n1[None, :] * (n_sub + 1.0) / 2.0
        base = n_sub + 1.0
        if tie_correct and n_sub > 1:
            base = base - ties[:, None] / (n_sub * (n_sub - 1.0))
        sd = np.sqrt(np.maximum(n1 * n2 / 12.0 * base, 0.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            zz = np.where(sd > 0, (rsums - expected) / np.where(sd > 0, sd, 1.0), 0.0)
        z[:, outcols] = zz
    pv = 2.0 * stats.norm.sf(np.abs(z))
    return z, pv


# ----------------------------------------------------------------------
# logreg scores (scanpy's third method)
# ----------------------------------------------------------------------


def _logreg_w0(p: int, n_groups: int, seed: int, device) -> torch.Tensor:
    """The start coefficients: 0.01 x a standard normal [p, G] from a
    generator on ``device`` seeded with ``seed``."""

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return 0.01 * torch.randn((p, n_groups), generator=gen, dtype=torch.float32, device=device)


def _logreg_engine(m):
    """``(mv, rmv)``: on a card, the matrix densified there in float32 while
    it fits ``DensifiedOperator``'s budget (two float32 GEMMs a step; the
    gather engine takes ~0.1 s a product at 100,000 x 30,000 there, and
    the densified engine's 16-bit hi/lo payload is too coarse: 300 steps
    amplify its rounding to 1.5e-2 of the coefficients); else the gather
    engine, the JAX package's ``ell_spmm`` over both layouts."""

    from .linalg.operators import DenseOperator, DensifiedOperator, SparseOperator
    from .ops.spmm import ell_scatter_densify

    n, p = m.shape
    if m.device.type == "cuda" and 4 * n * p <= DensifiedOperator.hbm_budget_bytes(m.device):
        r = m._layout_for("row")
        op = DenseOperator(ell_scatter_densify(r.ell_data, r.ell_ids, r.row_nnz, p)[:n].float())
    else:
        op = SparseOperator.from_matrix(m)
    return op.mv, op.rmv


def _logreg_scores(
    m, codes: np.ndarray, n_groups: int, *, lam: float, iters: int,
    lr: float, seed: int, _W0=None,
):
    """Multinomial logistic regression coefficients ``[p, G]`` (float64
    host): full-batch Nesterov descent, forward ``X @ W`` and gradient
    ``X^T (softmax - Y) / n + lam W``, two products a step
    (:func:`_logreg_engine`). ``_W0`` replaces the seeded start (the tests
    pass the JAX package's)."""

    n, p = m.shape
    dev = m.device
    Y = torch.nn.functional.one_hot(torch.as_tensor(codes, device=dev), n_groups).float()
    W = (_logreg_w0(p, n_groups, seed, dev) if _W0 is None
         else torch.as_tensor(np.asarray(_W0), dtype=torch.float32, device=dev))
    b = torch.zeros(n_groups, dtype=torch.float32, device=dev)
    vW, vb = torch.zeros_like(W), torch.zeros_like(b)
    mv, rmv = _logreg_engine(m)

    def grads(W, b):
        logits = mv(W) + b[None, :]
        logits = logits - logits.amax(dim=1, keepdim=True)
        P = torch.exp(logits)
        P = P / P.sum(dim=1, keepdim=True)
        D = (P - Y) / n
        return rmv(D) + lam * W, D.sum(dim=0)

    for _ in range(iters):
        gW, gb = grads(W + 0.9 * vW, b + 0.9 * vb)
        vW = 0.9 * vW - lr * gW
        vb = 0.9 * vb - lr * gb
        W, b = W + vW, b + vb
    return W.cpu().numpy().astype(np.float64)


# ----------------------------------------------------------------------
# public API
# ----------------------------------------------------------------------


@precision_policy()
def rank_genes_groups(
    m,
    labels: Sequence,
    *,
    method: str = "t-test",
    groups: str | Sequence = "all",
    reference: str = "rest",
    var_names: Optional[Sequence] = None,
    n_genes: Optional[int] = None,
    log1p_input: bool = True,
    tie_correct: bool = True,
    pts: bool = False,
    block: Optional[int] = None,
) -> DEResult:
    """Rank genes characterizing each group (scanpy's surface).

    ``m``: a ``SparseMatrix`` [cells, genes], typically log1p-normalized
    (its device runs the kernels). ``method``: 't-test',
    't-test_overestim_var', 'wilcoxon' or 'logreg' (coefficients as
    scores; the p-value fields are NaN). ``groups``: 'all' or a subset of
    label values; ``reference``: 'rest' or one label value. ``n_genes``
    truncates each ranking. ``log1p_input`` de-logs the fold changes.
    ``tie_correct``: the exact tie correction of the wilcoxon variance.
    ``pts``: the fraction of expressing cells per group and in the rest
    (needed by :meth:`DEResult.filter`). ``block``: genes per wilcoxon
    rank block (default: ~8 ``[block, W]`` buffers within ~2 GB, W the
    most stored entries of a gene).
    """

    if method not in ("t-test", "t-test_overestim_var", "wilcoxon", "logreg"):
        raise ValueError(f"Unknown method {method!r}")
    n, p = m.shape
    labels = list(labels.cpu().numpy() if isinstance(labels, torch.Tensor) else labels)
    names, codes = m._batch_codes(labels, n, "row")
    n_groups = len(names)
    if reference != "rest" and reference not in names:
        raise ValueError(f"reference {reference!r} is not a label value")
    if isinstance(groups, str) and groups == "all":
        sel = [g for g in names if g != reference]
    else:
        missing = [g for g in groups if g not in names]
        if missing:
            raise ValueError(f"groups {missing!r} are not label values")
        sel = [g for g in groups if g != reference]
    if not sel:
        raise ValueError("No groups left to test against the reference")
    gid = {g: i for i, g in enumerate(names)}
    group_ids = [gid[g] for g in sel]
    ref_id = None if reference == "rest" else gid[reference]

    sizes, mean, var = _full_moments(m, codes, n_groups)
    tot_size = sizes.sum()
    tot_sum = mean * sizes[None, :]

    var_names = np.arange(p) if var_names is None else np.asarray(var_names)
    if var_names.shape[0] != p:
        raise ValueError(f"var_names length ({var_names.shape[0]}) != n_genes ({p})")
    k = p if n_genes is None else min(int(n_genes), p)

    if method == "wilcoxon":
        scores, pvals = _wilcoxon_scores(m, codes, group_ids, ref_id, n_groups,
                                         tie_correct=tie_correct, block=block)
    elif method == "logreg":
        kw = dict(lam=1e-4, iters=300, lr=1.0, seed=0)
        if ref_id is None:
            scores = _logreg_scores(m, codes, n_groups, **kw)[:, group_ids]
        else:
            sub_mask = np.isin(codes, group_ids + [ref_id])
            remap = {g: i for i, g in enumerate(group_ids + [ref_id])}
            sub_codes = np.asarray([remap[c] for c in codes[sub_mask]], np.int64)
            scores = _logreg_scores(m.select_rows(sub_mask), sub_codes, len(remap),
                                    **kw)[:, : len(group_ids)]
        pvals = np.full_like(scores, np.nan)

    out_names, out_scores, out_p, out_padj, out_lfc = {}, {}, {}, {}, {}
    out_pts, out_ptsr = ({}, {}) if pts else (None, None)
    if pts:
        gcnt = m._batch_spmm("col", codes, "count").cpu().numpy().astype(np.float64)
        tot_cnt = gcnt.sum(axis=1)
    for j, g in enumerate(sel):
        i = gid[g]
        n1, m1, v1 = sizes[i], mean[:, i], var[:, i]
        if ref_id is None:
            n2 = tot_size - n1
            s2 = tot_sum.sum(axis=1) - tot_sum[:, i]
            m2 = s2 / max(n2, 1.0)
            # pooled rest variance from the total sumsq less the group's
            ssq_tot = (var * np.maximum(sizes - 1.0, 1.0)[None, :] + tot_sum * mean).sum(axis=1)
            ssq_g = v1 * max(n1 - 1.0, 1.0) + tot_sum[:, i] * m1
            v2 = np.maximum((ssq_tot - ssq_g - s2 * m2) / max(n2 - 1.0, 1.0), 0.0)
        else:
            n2, m2, v2 = sizes[ref_id], mean[:, ref_id], var[:, ref_id]

        if method in ("wilcoxon", "logreg"):
            sc, pv = scores[:, j], pvals[:, j]
        else:
            sc, pv = _welch(m1, v1, n1, m2, v2, n2,
                            overestim=(method == "t-test_overestim_var"))
        padj = pv if np.isnan(pv).all() else _bh_adjust(pv)
        lfc = _log2_fold_change(m1, m2, expm1=log1p_input)
        order = np.argsort(-sc, kind="stable")[:k]
        out_names[g] = var_names[order]
        out_scores[g] = np.asarray(sc, np.float64)[order]
        out_p[g] = pv[order]
        out_padj[g] = padj[order]
        out_lfc[g] = lfc[order]
        if pts:
            frac_in = gcnt[:, i] / max(n1, 1.0)
            if ref_id is None:
                frac_out = (tot_cnt - gcnt[:, i]) / max(tot_size - n1, 1.0)
            else:
                frac_out = gcnt[:, ref_id] / max(sizes[ref_id], 1.0)
            out_pts[g] = frac_in[order]
            out_ptsr[g] = frac_out[order]

    return DEResult(
        names=out_names, scores=out_scores, pvals=out_p, pvals_adj=out_padj,
        logfoldchanges=out_lfc, method=method, reference=reference,
        pts=out_pts, pts_rest=out_ptsr,
    )
