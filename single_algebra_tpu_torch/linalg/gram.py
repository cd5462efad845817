"""Gram-matrix PCA engine: exact PCA in two data passes, row-bucketed.

Counterpart of ``single_algebra_tpu/linalg/gram.py`` (see its module
docs for the method). In short:

1. **Densify and contract**: each row slab of the column-tiled payload is
   expanded to a dense transposed ``D [Pp, slab]`` by the densify kernel
   (``ops/densify.py``) and contracted ``G += D @ D^T``. Three value
   tiers: int8 (``torch._int_mm``, exact int32 slab products), bf16
   (float32-accumulated) and f32 (full float32).
2. **Solve in p-space**: the top-k eigenpairs of the (optionally
   centered) Gram give the right singular vectors; ``eig(G_c) = s^2``.
   Small Grams (``pp <= 4096``) get an exact ``eigh``, larger ones the
   randomized solve over a rank-1-centered operator.
3. **Project**: ``T = A V - 1 (mu^T V)`` with a second densify pass.

Rows are bucketed by width class (8, 16, 32, ... slots per tile) so each
bucket's payload is padded only to its own width; the plan and the
payload are the JAX package's, byte for byte.

PyTorch idiom in place of JAX's: the Gram and the projection accumulate
in place into preallocated tensors (JAX needed loop carries), the engine
lives on one explicit ``device``, and a slab is a window (offset and
stride) into the bucket payload rather than a ``dynamic_slice`` copy.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Tuple

import numpy as np
import torch

from ..ops.densify import tiled_ell_densify_t
from ..types import PowerIterationNormalizer
from ..utils.tracing import count, span
from .operators import DenseOperator, _sync, hbm_bytes
from .svd import randomized_svd, svd_flip

__all__ = [
    "GramPCAEngine",
    "gram_matrix",
    "gram_pass",
    "gram_pca_graph",
    "topk_psd_eigh",
    "solve_gram_topk",
    "EIGH_MAX_PP",
]


def _slab_for(n: int) -> int:
    """Row-slab granularity: 8192 at scale, 1024 for small inputs so
    per-bucket padding stays proportionate."""

    return 8192 if n >= 65536 else 1024


def width_classes_np(w: np.ndarray) -> np.ndarray:
    """Bucket width of each row: the next power-of-two multiple of 8 >= w
    (exact integer doubling)."""

    w = np.asarray(w, np.int64)
    out = np.full(w.shape, 8, np.int64)
    mask = out < w
    while mask.any():
        out[mask] <<= 1
        mask = out < w
    return out


def topk_psd_eigh(Gc: torch.Tensor, k: int):
    """Exact top-k eigenpairs of a PSD matrix -> ``(s, vt)`` in its dtype,
    with ``s = sqrt(eig)`` and the V-based svd_flip sign convention.

    On a CUDA device the eigendecomposition runs in float64: cuSOLVER's
    float32 ``eigh`` of a 512-wide centered Gram left 8.1e-5 relative
    error in its top eigenvalue on an H100, where LAPACK's float32 leaves
    3.7e-7 and float64 1.2e-9 (the small SVDs of the Lanczos solvers run
    in float64 for the same reason)."""

    A = Gc.double() if Gc.device.type == "cuda" else Gc
    w, V = torch.linalg.eigh(A)  # ascending
    s = torch.sqrt(torch.clamp(w.flip(0)[:k], min=0.0))
    vt = V.flip(1)[:, :k].T
    idx = torch.argmax(torch.abs(vt), dim=1)
    signs = torch.sign(vt[torch.arange(k, device=vt.device), idx])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return s.to(Gc.dtype), (vt * signs[:, None]).to(Gc.dtype)


# Grams at or below this width get the exact eigh solve; above it, the
# randomized solve over the rank-1-centered operator
EIGH_MAX_PP = 4096


def _solve_topk(
    Gs, mu, n, seed, *, k, center, oversamples=10, iters=6, omega=None
):
    """Shared solve policy: exact eigh for small Grams, the randomized
    solve over the rank-1-centered operator for large ones, where
    ``oversamples``/``iters`` are minimums (a sketch reaching well past k
    resolves the top k to the f32 floor). ``omega`` replaces the seeded
    sketch of the randomized branch."""

    n_f = float(n)
    with span("gram.solve", pp=Gs.shape[0]):
        if Gs.shape[0] <= EIGH_MAX_PP:
            Gc = Gs - n_f * (mu[:, None] * mu[None, :]) if center else Gs
            return topk_psd_eigh(Gc, k)
        solve_op = _CenteredGram(Gs, mu, n_f) if center else DenseOperator(Gs)
        os_eff = max(oversamples, min(k + 14, max(Gs.shape[0] - k, 0)))
        it_eff = max(iters, 8)
        res = randomized_svd(
            solve_op, k, os_eff, it_eff, PowerIterationNormalizer.QR,
            seed=seed, omega=omega,
        )
        _, vt = svd_flip(res.u, res.vt, u_based_decision=False)
        s = torch.sqrt(torch.clamp(res.s, min=0.0))
        return s, vt


def solve_gram_topk(G, mu, n, seed, *, k, center, omega=None):
    """Public entry of the shared Gram solve (see :func:`_solve_topk`)."""

    return _solve_topk(G, mu, n, seed, k=k, center=center, omega=omega)


class _CenteredGram:
    """Symmetric operator ``G - c * mu mu^T`` (rank-1-centered Gram).

    ``mv`` deflates the operand against ``mu`` first: with
    ``beta = (mu^T B)/||mu||^2`` and ``Bp = B - mu beta``,

        Gc @ B = [G @ Bp - c mu (mu^T Bp)] + (Gc @ mu) beta

    where ``g_mu = Gc @ mu`` is computed once. ``G @ Bp`` is then born at
    the centered scale, so no power iteration stores a float32 product at
    the uncentered scale (see the JAX class)."""

    def __init__(self, G: torch.Tensor, mu: torch.Tensor, c: float):
        self.G, self.mu, self.c = G, mu, c
        mu2 = mu @ mu
        self.inv_mu2 = torch.where(
            mu2 > 0, 1.0 / torch.clamp(mu2, min=1e-30), torch.zeros_like(mu2)
        )
        self.g_mu = G @ mu - c * mu * mu2

    @property
    def shape(self):
        return tuple(self.G.shape)

    @property
    def dtype(self):
        return self.G.dtype

    @property
    def device(self):
        return self.G.device

    def mv(self, B):
        beta = (self.mu @ B) * self.inv_mu2  # [k]
        Bp = B - self.mu[:, None] * beta[None, :]
        t = self.mu @ Bp  # ~0 residual
        return (
            self.G @ Bp
            - self.c * self.mu[:, None] * t[None, :]
            + self.g_mu[:, None] * beta[None, :]
        )

    rmv = mv  # symmetric


@dataclasses.dataclass
class GramPCAEngine:
    """Row-bucketed tiled payloads + slab-densify machinery on ``device``.

    ``bdata[c]``/``blocal[c]`` hold bucket c's transposed tiled payload
    ``[nt * wt_c, R_c]``; ``pos`` maps natural row -> bucketed position;
    ``gidx`` maps bucketed position -> natural row (n = padding sentinel).
    ``meta = (wt_max, ntiles, ct, exact, i8)``: ``exact`` means bf16-exact
    values, ``i8`` integers in [-127, 127] (the int8 Gram tier);
    ``bwidths`` the per-bucket (wt_c, R_c) pairs.
    """

    bdata: Tuple[torch.Tensor, ...]
    blocal: Tuple[torch.Tensor, ...]
    pos: torch.Tensor  # [n] int64: natural row -> bucketed position
    gidx: torch.Tensor  # [sum R_c] int64: bucketed position -> row (or n)
    shape: Tuple[int, int]
    meta: Tuple[int, int, int, bool, bool]
    bwidths: Tuple[Tuple[int, int], ...]
    device: torch.device
    _gram: torch.Tensor | None = dataclasses.field(default=None, init=False, repr=False,
                                                   compare=False)  # gram_cached's

    COL_TILES = (256, 512, 1024)

    # -- capacity planning -------------------------------------------------

    @classmethod
    def _bucket_plan(cls, m, col_tile: int):
        """Host bucketing plan ``(plan, total_bytes, slab, ntiles)``:
        ``plan`` lists (class_width, row_idx) and ``total_bytes`` charges
        the payload, G, two slab workspaces and the blocked path's buffers
        exactly as the JAX package does, so both packages take the same
        decisions (the port's in-place blocked path needs less than the
        charged pair carries). Kept on the matrix per ``col_tile``."""

        return m._memo(("gram_plan", col_tile), lambda: cls._plan(m, col_tile))

    @staticmethod
    def _plan(m, col_tile: int):
        from ..sparse.convert import round_up, row_tile_widths

        indptr, indices, _ = m._row_csr(values=False)
        n, p = m.shape
        slab = _slab_for(n)
        w_r = row_tile_widths(indptr, indices, n, col_tile)
        classes = width_classes_np(np.maximum(w_r, 1))
        ntiles = max(-(-p // col_tile), 1)
        pp = ntiles * col_tile
        plan, total = [], 0
        for c in np.unique(classes):
            rows = np.where(classes == c)[0]
            rc = round_up(len(rows), slab)
            plan.append((int(c), rows))
            total += ntiles * int(c) * rc * 8
        if m.values_int8_exact():
            ws_item = 1
        elif m.values_bf16_exact():
            ws_item = 2
        else:
            ws_item = 4
        total += pp * pp * 4 + pp * slab * ws_item * 2
        rb = _gram_block(pp)
        if rb is not None:
            ppb = -(-pp // rb) * rb
            nb = ppb // rb
            total += nb * (nb + 1) // 2 * rb * rb * 4
            if pp % rb:
                total += ppb * ppb * 4
        return plan, total, slab, ntiles

    @staticmethod
    def hbm_budget_bytes(device: torch.device | str) -> int:
        """0.8 of the CUDA device's memory (the plan charges every large
        buffer itself). Other devices get the JAX package's 12 GiB
        fallback, so CPU runs plan as it does there."""

        total = hbm_bytes(device)
        return int(total * 0.8) if total is not None else 12 << 30

    @classmethod
    def choose_col_tile(cls, m, budget_bytes: int | None = None):
        """Smallest column tile whose bucketed payload fits the budget ->
        ``(col_tile, payload_bytes)``; the cheapest candidate when none
        fits, so callers decide via ``fits()``."""

        if budget_bytes is None:
            budget_bytes = cls.hbm_budget_bytes(m.device)
        best = None
        for ct in cls.COL_TILES:
            _, b, _, _ = cls._bucket_plan(m, ct)
            if best is None or b < best[1]:
                best = (ct, b)
            if b <= budget_bytes:
                return ct, b
        return best

    @classmethod
    def payload_bytes(cls, m) -> int:
        return cls.choose_col_tile(m)[1]

    @classmethod
    def fits(cls, m, budget_bytes: int | None = None) -> bool:
        if m.shape[1] > 40960:  # G itself would crowd out device memory
            return False
        if budget_bytes is None:
            budget_bytes = cls.hbm_budget_bytes(m.device)
        return cls.choose_col_tile(m, budget_bytes)[1] <= budget_bytes

    # -- construction ------------------------------------------------------

    @classmethod
    def build_host(cls, m):
        """The engine's arrays as numpy, on the host:
        ``(bdata, blocal, pos, gidx, shape, meta, bwidths)``."""

        from ..sparse.convert import fill_class_payload, round_up

        n, p = m.shape
        ct, _ = cls.choose_col_tile(m)
        plan, _, slab, nt = cls._bucket_plan(m, ct)
        indptr, indices, vals = m._row_csr()

        bdata, blocal, bwidths = [], [], []
        pos = np.zeros(n, np.int64)
        gidx_parts = []
        offset = 0
        wt_max = 8
        for c, rows in plan:
            rc = round_up(len(rows), slab)
            td, tl = fill_class_payload(indptr, indices, vals, rows, p, ct, c, rc)
            bdata.append(td)
            blocal.append(tl)
            bwidths.append((c, rc))
            wt_max = max(wt_max, c)
            pos[rows] = offset + np.arange(len(rows))
            g = np.full(rc, n, np.int64)
            g[: len(rows)] = rows
            gidx_parts.append(g)
            offset += rc
        meta = (wt_max, nt, ct, m.values_bf16_exact(), m.values_int8_exact())
        return (bdata, blocal, pos, np.concatenate(gidx_parts), (n, p), meta,
                bwidths)

    @classmethod
    def from_arrays(
        cls, bdata, blocal, pos, gidx, shape, meta, bwidths, device="cuda"
    ) -> "GramPCAEngine":
        """Engine on ``device`` from numpy arrays — the host build's, or
        the JAX engine's fields (``np.asarray`` of each)."""

        device = torch.device(device)

        def put(a, dtype):
            a = np.ascontiguousarray(a)
            if not a.flags.writeable:  # e.g. np.asarray of a JAX array
                a = a.copy()
            return torch.as_tensor(a, dtype=dtype, device=device)

        return cls(
            tuple(put(a, torch.float32) for a in bdata),
            tuple(put(a, torch.int32) for a in blocal),
            put(pos, torch.int64),
            put(gidx, torch.int64),
            tuple(int(v) for v in shape),
            (int(meta[0]), int(meta[1]), int(meta[2]), bool(meta[3]), bool(meta[4])),
            tuple((int(w), int(r)) for w, r in bwidths),
            device,
        )

    @classmethod
    def from_matrix(cls, m) -> "GramPCAEngine":
        """Host payload build, then upload to ``m.device``, synchronised
        there; the two times are kept in ``build_seconds``."""

        t0 = time.perf_counter()
        with span("gram.build_host"):
            arrays = cls.build_host(m)
        t1 = time.perf_counter()
        with span("gram.upload"):
            eng = cls.from_arrays(*arrays, device=m.device)
            _sync(m.device)
            count("gram.upload_bytes", eng.nbytes)
        eng.build_seconds = {
            "host_payload": t1 - t0, "upload": time.perf_counter() - t1,
        }
        return eng

    # -- slab machinery ----------------------------------------------------

    @property
    def dtype(self):
        return torch.float32

    @property
    def n_padded(self) -> int:
        return sum(rc for _, rc in self.bwidths)

    @property
    def nbytes(self) -> int:
        """Bytes of the engine's arrays on its device."""

        return sum(t.numel() * t.element_size()
                   for t in (*self.bdata, *self.blocal, self.pos, self.gidx))

    @property
    def p_padded(self) -> int:
        return self.meta[1] * self.meta[2]

    def _densify(self, b: int, i: int, out_dtype) -> torch.Tensor:
        """Slab i of bucket b -> dense [Pp, slab]."""

        wt, _ = self.bwidths[b]
        slab = _slab_for(self.shape[0])
        return tiled_ell_densify_t(
            self.bdata[b], self.blocal[b], wt=wt, ntiles=self.meta[1],
            col_tile=self.meta[2], out_dtype=out_dtype,
            row_offset=i * slab, rows=slab,
        )

    def _slab_dot(self, b: int, i: int, M: torch.Tensor, transposed: bool):
        """One slab product in full float32: ``D^T @ M`` ([slab, k],
        transposed=False) or ``D @ M_slab`` ([Pp, k], transposed=True).

        The slab is densified straight to float32 and multiplied once in
        float32 with TF32 off. That carries the 24 bits that the JAX
        package's three bf16 operand terms (``bf16_terms``) carry on the
        TPU's bf16 matrix unit."""

        D = self._densify(b, i, torch.float32)
        return D @ M if transposed else D.T @ M

    def _project_bucketed(self, Bp: torch.Tensor) -> torch.Tensor:
        """``A_perm @ B`` in bucketed row order -> [sum R_c, k] f32."""

        slab = _slab_for(self.shape[0])
        with span("gram.project", width=Bp.shape[1]):
            out = torch.empty(
                (self.n_padded, Bp.shape[1]), dtype=torch.float32, device=self.device
            )
            offset = 0
            for b, (_, rc) in enumerate(self.bwidths):
                for i in range(rc // slab):
                    r0 = offset + i * slab
                    out[r0:r0 + slab] = self._slab_dot(b, i, Bp, transposed=False)
                offset += rc
            return out

    def mv(self, B):
        """A @ B via slab densify passes ([p, k] -> [n, k])."""

        Bp = torch.zeros(
            (self.p_padded, B.shape[1]), dtype=torch.float32, device=self.device
        )
        Bp[: B.shape[0]] = B
        return self._project_bucketed(Bp)[self.pos].to(B.dtype)

    def rmv(self, C):
        """A^T @ C via slab densify passes ([n, k] -> [p, k])."""

        slab = _slab_for(self.shape[0])
        k = C.shape[1]
        # route C rows into bucketed positions (padding slots read the zero
        # row appended at index n)
        Cx = torch.cat(
            [C.float(), torch.zeros((1, k), dtype=torch.float32, device=C.device)]
        )
        Cb = Cx[self.gidx]  # [sum R_c, k]
        acc = torch.zeros((self.p_padded, k), dtype=torch.float32, device=self.device)
        offset = 0
        for b, (_, rc) in enumerate(self.bwidths):
            for i in range(rc // slab):
                r0 = offset + i * slab
                acc += self._slab_dot(b, i, Cb[r0:r0 + slab], transposed=True)
            offset += rc
        return acc[: self.shape[1]].to(C.dtype)

    # -- cached Gram -------------------------------------------------------

    def gram_cached(self) -> torch.Tensor:
        if self._gram is None:
            self._gram = gram_matrix(self)
        return self._gram


def _gram_block(pp: int) -> int | None:
    """Row-block size of the symmetric-half contraction, or None for one
    full product per slab (the 2x flop saving is noise below ~4k width)."""

    return 2048 if pp > 4096 else None


def _bf16_mm_f32():
    """bf16 x bf16 -> float32 product, when this torch has the ``mm.dtype``
    overload (CUDA only): no rounding of the product to bf16."""

    return hasattr(torch.ops.aten.mm, "dtype")


def gram_matrix(
    eng: GramPCAEngine, *, sym: bool = True, rb: int | None = None
) -> torch.Tensor:
    """``A^T A`` as ``[Pp, Pp]`` f32 — slab densify + contraction.

    Tiers, chosen by what the stored values support:

    - **int8** (integers in [-127, 127]): slabs densify to int8 and
      contract with ``torch._int_mm`` to an exact int32 product per slab
      (slab <= 8192 terms x 127^2 < 2^31), added into the float32 Gram in
      slab order — the JAX package's arithmetic, so the two Grams agree
      bit for bit. An int32 partial above 2^24 rounds when it is added.
    - **bf16** (bf16-exact values): bf16 slabs; on CUDA, ``torch.mm`` with
      a float32 output where torch has it, else the slab upcast to
      float32 and one float32 product — exact products either way.
    - **f32**: float32 slabs and float32 products (TF32 off).

    ``sym`` (default) with ``pp > 4096`` takes the symmetric-half path:
    only the lower-triangular 2048-row block pairs ``G[r, c] += D_r D_c^T``
    (r >= c) are computed, accumulated in place into G, and the strict
    lower blocks are mirrored once at the end. The slab is zero-padded to
    a block multiple ``ppb``.
    """

    exact, i8_vals = eng.meta[3], eng.meta[4]
    slab = _slab_for(eng.shape[0])

    def slabs(dtype):
        for b, (_, rc) in enumerate(eng.bwidths):
            for i in range(rc // slab):
                count("gram.slabs")
                yield eng._densify(b, i, dtype)

    i8 = exact and i8_vals and slab * 127 ** 2 < 2 ** 31
    with span("gram.pass", tier="int8" if i8 else "bf16" if exact else "f32"):
        return gram_pass(slabs, eng.p_padded, eng.device, exact=exact, i8=i8, sym=sym, rb=rb)


def gram_pass(slabs, pp: int, dev, *, exact: bool, i8: bool, sym: bool = True,
              rb: int | None = None) -> torch.Tensor:
    """``sum_s D_s D_s^T`` as ``[pp, pp]`` float32 over the slabs that
    ``slabs(dtype)`` yields in order (each densified to ``dtype``, ``[pp,
    rows]``, on ``dev``), in :func:`gram_matrix`'s tiers (``i8``: int8
    slabs; ``exact``: bf16 slabs; else float32) and with its symmetric-half
    blocks. The sharded Gram engine runs it per device."""

    bf16_native = exact and not i8 and torch.device(dev).type == "cuda" and _bf16_mm_f32()
    dtype = torch.int8 if i8 else (torch.bfloat16 if exact else torch.float32)

    def dense_slabs():
        for D in slabs(dtype):
            yield D.float() if exact and not i8 and not bf16_native else D

    def acc_dot(G_blk, a, c):
        """``G_blk += a @ c^T`` in the tier's arithmetic."""

        if i8:
            G_blk += torch._int_mm(a, c.T)
        elif bf16_native:
            G_blk += torch.mm(a, c.T, out_dtype=torch.float32)
        else:
            G_blk.addmm_(a, c.T)

    if rb is None:
        rb = _gram_block(pp) if sym else None
    elif not sym:
        rb = None
    if rb is None:
        G = torch.zeros((pp, pp), dtype=torch.float32, device=dev)
        for D in dense_slabs():
            acc_dot(G, D, D)
        return G

    ppb = -(-pp // rb) * rb
    nb = ppb // rb
    G = torch.zeros((ppb, ppb), dtype=torch.float32, device=dev)
    for D in dense_slabs():
        if ppb != pp:
            D = torch.nn.functional.pad(D, (0, 0, 0, ppb - pp))
        for r in range(nb):
            for c in range(r + 1):
                acc_dot(
                    G[r * rb:(r + 1) * rb, c * rb:(c + 1) * rb],
                    D[r * rb:(r + 1) * rb], D[c * rb:(c + 1) * rb],
                )
    for r in range(nb):
        for c in range(r):
            G[c * rb:(c + 1) * rb, r * rb:(r + 1) * rb] = (
                G[r * rb:(r + 1) * rb, c * rb:(c + 1) * rb].T
            )
    return G[:pp, :pp] if ppb != pp else G


def gram_pca_graph(
    eng: GramPCAEngine,
    G: torch.Tensor,
    mean: torch.Tensor,  # [p] (zeros when uncentered)
    seed,
    *,
    k: int,
    center_svd: bool,
    center_T: bool,
    want_transform: bool,
    solver_oversamples: int = 10,
    solver_iters: int = 6,
    mask_idx: torch.Tensor | None = None,
    omega: torch.Tensor | None = None,
):
    """(s, vt, T) from the cached Gram matrix.

    ``center_svd`` handles the rank-1 mean term (true PCA); ``center_T``
    centers the projection (the reference applies it even on the
    uncentered Lanczos path). ``mask_idx`` restricts features to a subset:
    the masked Gram is a submatrix. ``omega`` replaces the seeded sketch
    of the large-Gram randomized solve.
    """

    n, p = eng.shape
    pp = G.shape[0]
    mean_p = torch.zeros(pp, dtype=torch.float32, device=G.device)
    mean_p[: mean.shape[0]] = mean
    if mask_idx is not None:
        Gs = G[mask_idx][:, mask_idx]
        mu = mean_p[mask_idx]
    else:
        Gs, mu = G, mean_p

    s, vt = _solve_topk(
        Gs, mu, n, seed, k=k, center=center_svd,
        oversamples=solver_oversamples, iters=solver_iters, omega=omega,
    )
    vt_out = vt[:, :p] if mask_idx is None else vt

    T = None
    if want_transform:
        # V back to padded full width for the slab projection
        Vp = torch.zeros((pp, k), dtype=torch.float32, device=G.device)
        if mask_idx is not None:
            Vp[mask_idx] = vt.T
        else:
            Vp[: vt.shape[1]] = vt.T
        T = eng._project_bucketed(Vp)[eng.pos]
        if center_T:
            # mu and vt share the solve width (masked or padded-full)
            T -= (mu @ vt.T)[None, :]
    return s, vt_out, T
