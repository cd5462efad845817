"""Row-sharded Gram-PCA engine: exact two-pass PCA over a device mesh.

Counterpart of ``single_algebra_tpu/parallel/gram.py``. Each mesh entry
holds a contiguous block of ``rs = ceil(n / ndev)`` rows as column-tiled
payloads, one per width class of the GLOBAL bucket plan
(``GramPCAEngine._bucket_plan``: 8, 16, 32, ... slots per tile), each
class padded to its largest per-device population ``Rc`` and cut into
sub-slabs of ``slab_c`` rows (8,192 at scale; a multiple of 128 for a
small class, so a near-empty class pays little padding). The payloads
and the natural -> bucketed position map are the JAX package's, array for
array.

``gram()``: each device densifies its sub-slabs (``tiled_ell_densify_t``)
and contracts them into a local ``[pp, pp]`` Gram in the single-card
tiers and blocks (``linalg/gram.py::gram_pass``); the local Grams are
added on the home device in slab order: the one reduction of a fit, of
``pp^2`` floats whatever ``n`` is. The solve runs on the home device;
``project()`` is local to each device (float32 densify + GEMM, then the
gather back to natural row order) and gathers the score rows on the home
device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..linalg.gram import GramPCAEngine, gram_pass, solve_gram_topk
from ..linalg.operators import DensifiedOperator
from ..ops.densify import tiled_ell_densify_t
from ..sparse import convert as _cv
from ..types import precision_policy
from .sharded import Mesh, _psum, _replicas, _upload, mesh_budget_bytes

__all__ = ["ShardedGram", "sharded_gram_pca"]


def _slab_for_rows(cap: int, slab: int | None) -> int:
    """Sub-slab rows of a width class with ``cap`` rows on its fullest
    device: 8,192 at scale, else ``cap`` rounded up to 128 (to 1,024 past
    1,024 rows, so a block of 1,024 rows divides it); ``slab`` when the
    caller fixes it."""

    if slab is not None:
        return slab
    if cap >= 8192:
        return 8192
    s = max(_cv.round_up(max(cap, 1), 128), 128)
    if s > 1024:
        s = min(_cv.round_up(s, 1024), 8192)
    return s


@dataclasses.dataclass
class ShardedGram:
    """Row-sharded, row-bucketed tiled payloads + the Gram machinery.

    ``bdata[d][c]`` / ``blocal[d][c]`` hold device ``d``'s payload of width
    class ``c`` ``[nt * wc, Rc]`` (float32 values, int32 tile-local ids)
    on ``mesh.devices[d]``; ``pos_local[d]`` ``[rs]`` maps each of the
    device's natural rows to its position in the concatenation of its
    per-class projections (rows past ``n`` point at an appended zero row).
    ``bwidths`` is the per-class ``(wc, Rc, slab_c)`` list; ``meta = (nt,
    ct, exact, i8)`` (``i8``: integer values in [-127, 127], the int8 Gram
    tier)."""

    bdata: Tuple[Tuple[torch.Tensor, ...], ...]
    blocal: Tuple[Tuple[torch.Tensor, ...], ...]
    pos_local: Tuple[torch.Tensor, ...]
    shape: Tuple[int, int]
    meta: Tuple[int, int, bool, bool]
    bwidths: Tuple[Tuple[int, int, int], ...]
    mesh: Mesh
    _gram: torch.Tensor | None = dataclasses.field(default=None, init=False, repr=False,
                                                   compare=False)  # gram_cached's

    @classmethod
    def from_matrix(cls, m, mesh: Mesh, axis_name: str = "rows", col_tile: int | None = None,
                    slab: int | None = None) -> "ShardedGram":
        n, p = m.shape
        ndev = mesh.shape[axis_name]
        rs = -(-n // ndev)
        if slab is not None and not (slab <= 1024 or slab % 1024 == 0):
            raise ValueError(f"slab={slab} must be <= 1024 or a multiple of 1024")
        if col_tile is None:
            # the payload splits over the mesh; entries on one card share it
            budget = mesh_budget_bytes(mesh, DensifiedOperator.hbm_budget_bytes)
            col_tile, _ = GramPCAEngine.choose_col_tile(m, budget)
        ct = col_tile
        nt = max(-(-p // ct), 1)
        indptr, indices, data = m._row_csr()

        plan, _, _, nt_plan = GramPCAEngine._bucket_plan(m, ct)
        if nt_plan != nt:
            raise RuntimeError(f"bucket plan has {nt_plan} tiles, expected {nt}")
        classes = np.empty(n, np.int64)
        for c, rows_c in plan:
            classes[rows_c] = c
        class_list = [int(c) for c, _ in plan]

        dev_rows, caps = [], {c: 0 for c in class_list}
        for d in range(ndev):
            r0, r1 = d * rs, min((d + 1) * rs, n)
            cd = classes[r0:r1]
            per = {c: np.where(cd == c)[0] + r0 for c in class_list}
            for c in class_list:
                caps[c] = max(caps[c], len(per[c]))
            dev_rows.append(per)
        bwidths = tuple(
            (c, _cv.round_up(max(caps[c], 1), _slab_for_rows(caps[c], slab)),
             _slab_for_rows(caps[c], slab))
            for c in class_list
        )

        r_tot = sum(rc for _, rc, _ in bwidths)
        bdata, blocal, pos_local = [], [], []
        for d, dev in enumerate(mesh.devices):
            pos = np.full(rs, r_tot, np.int64)  # padding -> the zero row
            tds, tls, offset = [], [], 0
            for c, rc, _ in bwidths:
                td = np.zeros((nt * c, rc), np.float32)
                tl = np.zeros((nt * c, rc), np.int32)
                rows = dev_rows[d][c]
                if len(rows):
                    _cv.fill_class_payload(indptr, indices, data, rows, p, ct, c, rc,
                                           out_td=td, out_tl=tl)
                    pos[rows - d * rs] = offset + np.arange(len(rows))
                tds.append(_upload(td, dev))
                tls.append(_upload(tl, dev))
                offset += rc
            bdata.append(tuple(tds))
            blocal.append(tuple(tls))
            pos_local.append(_upload(pos, dev))
        return cls(tuple(bdata), tuple(blocal), tuple(pos_local), (n, p),
                   (nt, ct, m.values_bf16_exact(), m.values_int8_exact()), bwidths, mesh)

    # -- capacity accounting ---------------------------------------------

    @property
    def ndev(self) -> int:
        return len(self.bdata)

    @property
    def p_padded(self) -> int:
        return self.meta[0] * self.meta[1]

    @property
    def payload_bytes(self) -> int:
        """Device-resident payload bytes (values f32 + local ids i32)."""

        return sum(a.numel() * 4 for per in self.bdata + self.blocal for a in per)

    @property
    def unbucketed_payload_bytes(self) -> int:
        """What one global-width payload would cost: every device slab
        padded to the widest class."""

        nt = self.meta[0]
        wt_max = max(c for c, _, _ in self.bwidths)
        slab_max = max(s for _, _, s in self.bwidths)
        rs = _cv.round_up(-(-self.shape[0] // self.ndev), slab_max)
        return 2 * self.ndev * nt * wt_max * rs * 4

    # -- device passes -----------------------------------------------------

    def _densify(self, d: int, b: int, i: int, dtype) -> torch.Tensor:
        """Sub-slab ``i`` of device ``d``'s class ``b`` -> dense ``[pp, slab_c]``."""

        c, _, slab_c = self.bwidths[b]
        nt, ct = self.meta[0], self.meta[1]
        return tiled_ell_densify_t(
            self.bdata[d][b], self.blocal[d][b], wt=c, ntiles=nt, col_tile=ct,
            out_dtype=dtype, row_offset=i * slab_c, rows=slab_c,
        )

    def _sub_slabs(self):
        return [(b, i) for b, (_, rc, slab_c) in enumerate(self.bwidths)
                for i in range(rc // slab_c)]

    def _local_gram(self, d: int) -> torch.Tensor:
        """Device ``d``'s ``[pp, pp]`` Gram over its sub-slabs, in class
        order."""

        _, _, exact, i8 = self.meta
        slab_max = max(s for _, _, s in self.bwidths)

        def slabs(dtype):
            for b, i in self._sub_slabs():
                yield self._densify(d, b, i, dtype)

        return gram_pass(slabs, self.p_padded, self.mesh.devices[d], exact=exact,
                         i8=exact and i8 and slab_max * 127 ** 2 < 2 ** 31)

    def gram(self) -> torch.Tensor:
        """``A^T A`` ``[pp, pp]`` on the home device: the local Grams, added
        in slab order (one held at a time beside the sum)."""

        return _psum((self._local_gram(d) for d in range(self.ndev)), self.mesh.home)

    def gram_cached(self) -> torch.Tensor:
        if self._gram is None:
            self._gram = self.gram()
        return self._gram

    def project(self, Vp: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        """Scores ``(A - 1 mu^T) V`` -> ``[n, k]`` on the home device in
        NATURAL row order (``Vp [pp, k]`` and ``corr [k]`` on the home
        device; each device projects its rows and restores their order by
        one local gather)."""

        k = Vp.shape[1]
        reps, creps = _replicas(Vp.float(), self.mesh), _replicas(corr.float(), self.mesh)
        outs = []
        for d, dev in enumerate(self.mesh.devices):
            parts = [self._densify(d, b, i, torch.float32).T @ reps[dev]
                     for b, i in self._sub_slabs()]
            Tb = torch.cat(parts + [torch.zeros((1, k), dtype=torch.float32, device=dev)])
            outs.append(Tb[self.pos_local[d]] - creps[dev][None, :])
        home = self.mesh.home
        return torch.cat([o.to(home) for o in outs])[: self.shape[0]]


@precision_policy()
def sharded_gram_pca(m, mesh: Mesh, n_components: int = 50, center: bool = True,
                     seed: int = 42, mask=None, axis_name: str = "rows"):
    """Exact two-pass PCA over the mesh -> ``ShardedPCAResult`` (scores on
    the home device, components, explained variance, mean, total
    variance). The engine is cached per (matrix, mesh) in the matrix's
    operator cache, its Gram on the engine. ``mask`` (boolean, length p)
    solves the masked columns' Gram submatrix."""

    from .pca import ShardedPCAResult

    key = ("sharded", "gram", mesh)
    op = m._operator_cache.get(key)
    if op is None:
        op = m._operator_cache[key] = ShardedGram.from_matrix(m, mesh, axis_name=axis_name)

    n, p = op.shape
    pp = op.p_padded
    k = n_components
    home = mesh.home
    s64, sq64 = m._host_col_stats()
    mean64 = s64 / n
    mean = torch.as_tensor(mean64.astype(np.float32), device=home)
    mu_full = torch.nn.functional.pad(mean, (0, pp - p))
    G = op.gram_cached()

    idx_np = None
    if mask is not None:
        mask = np.asarray(mask, bool)
        if mask.shape[0] != p:
            raise ValueError(
                "The mask vector length and the number of features (columns)"
                " have to be the same!"
            )
        idx_np = np.where(mask)[0]
        idx = torch.as_tensor(idx_np, device=home)
        Gs, mu_solve = G[idx][:, idx], mu_full[idx]
    else:
        Gs, mu_solve = G, mu_full

    s, vt = solve_gram_topk(Gs, mu_solve, n, seed, k=k, center=center)

    # V at padded full width for the local projections
    Vp = torch.zeros((pp, k), dtype=torch.float32, device=home)
    if idx_np is not None:
        Vp[idx] = vt.T
        comps = vt
    else:
        Vp[: vt.shape[1]] = vt.T
        comps = vt[:, :p]
    corr = mu_solve @ vt.T if center else torch.zeros(k, dtype=torch.float32, device=home)
    T = op.project(Vp, corr)

    ev64 = s.cpu().numpy().astype(np.float64) ** 2 / max(n - 1, 1)
    if center:
        var_all = (sq64 - mean64 * s64) / max(n - 1, 1)
        total_var = float(var_all.sum() if idx_np is None else var_all[idx_np].sum())
    else:
        total_var = float(ev64.sum())
    return ShardedPCAResult(T, comps, torch.as_tensor(ev64.astype(np.float32), device=home),
                            mean, total_var)
