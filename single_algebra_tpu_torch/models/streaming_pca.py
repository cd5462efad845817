"""Out-of-core streaming PCA: exact Gram accumulation over row slabs.

Counterpart of ``single_algebra_tpu/models/streaming_pca.py`` on one
device (see its module docs for the method). Only one row slab plus the
p x p Gram live on the device, so ``n`` is unbounded. Per caller-supplied
CSR chunk (any row count), re-slabbed to 8192-row device slabs:

1. host, on a worker thread (:func:`_prefetch`): slab -> overflow-free
   column-tiled payload in the wire format, int16 tile-local ids and,
   when the values are bf16-exact, the bf16 bit patterns as uint16;
2. device: upload, widen (ids to int32, bf16 bits to float32), densify
   with ``tiled_ell_densify_t`` (bf16 output for bf16-exact slabs, else
   float32), ``G += D D^T`` with float32 accumulation, and the slab's
   column sums and squared sums;
3. host: float64 accumulation of the moment vectors, and every
   ``fold_every`` slabs a fold of the device Gram into a float64 one.

``finalize()`` solves the top-k eigenpairs of the (optionally rank-1
centered) Gram through ``solve_gram_topk``, the Gram engine's solve;
``transform`` streams slabs through the same payload machinery.

The densify kernel takes float32 payloads and int32 ids only, so the
narrow wire format is widened on the card after the upload, never on the
host.

With ``mesh=`` (a ``parallel.Mesh``) each step takes a super-slab of up
to ``ndev`` consecutive slabs, one per mesh entry, padded to the group's
widest ``wt`` (:meth:`StreamingSparsePCA._iter_super_slabs`): every entry
densifies its own slab and forms its partial Gram and moments on its
device, and the partial Grams are added on the home device in slab order
(:func:`_accum_graph_mesh`), where ``G`` lives; ``transform`` projects
each slab on its device and gathers the rows there
(:func:`_project_graph_mesh`). Entries past the chunk's last slab get no
work, and only real slabs count towards ``fold_every``.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from ..linalg.gram import _bf16_mm_f32, solve_gram_topk
from ..ops.densify import tiled_ell_densify_t
from ..types import precision_policy

__all__ = ["StreamingSparsePCA"]

_SLAB = 8192
_HIGH_HALF = 1 if sys.byteorder == "little" else 0  # a float32's sign/exponent half


def _prefetch(gen, depth: int = 2):
    """Run a payload-building generator on a worker thread, staying up to
    ``depth`` items ahead of the consumer.

    The native converter releases the interpreter lock, so the host build
    of slab i+1 overlaps the upload and the device work of slab i. The
    bounded queue is the backpressure: at most ``depth`` built payloads
    (+1 in the consumer's hands) exist at once. Every item reaches the
    consumer, however slow it is: the end marker waits for room like any
    item (the JAX package's version drops a queued payload to make room
    for it, so a consumer that falls two items behind loses a slab). A
    consumer that stops early releases the producer and drops the queued
    payloads."""

    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        """A bounded put that re-checks the stop flag (a plain put would
        block forever once the consumer has gone); False when stopped."""

        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for item in gen:
                if not put(item):
                    return
        except BaseException as e:  # re-raised on the consumer thread
            err.append(e)
        finally:
            put(_END)

    threading.Thread(target=run, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        try:
            gen.close()
        except ValueError:  # still running on the worker, which now stops
            pass
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


def _bf16_exact(data: np.ndarray) -> bool:
    """True when every value survives a float32 -> bf16 -> float32 round
    trip (the native early-exit pass; torch when there is no native
    library). NaN is never exact."""

    from ..native import build as _native

    v = np.ascontiguousarray(data, np.float32)
    lib = _native.get_lib()
    if lib is not None:
        return bool(lib.f32_bf16_exact(v, len(v)))
    t = torch.from_numpy(v)
    return not bool(torch.any((t - t.to(torch.bfloat16).float()) != 0))


def _slab_payload(indptr, indices, data, n_rows, p, col_tile, exact=False):
    """One slab of at most 8192 rows -> its overflow-free tiled payload in
    the wire format ``(td, tl, wt, ntiles)``: ``td [nt * wt, 8192]``
    float32, or, when ``exact``, the bf16 bit patterns of the values as
    uint16 (the top half of each float32, which holds all of a bf16-exact
    value); ``tl`` the tile-local ids as int16. ``wt`` is the slab's
    densest (row, tile) group rounded up to 8."""

    from ..sparse.convert import csr_to_tiled_ell_split_numpy

    td, tl, wt, nt, _, _, ovw = csr_to_tiled_ell_split_numpy(
        indptr, indices, data, n_rows, p,
        col_tile=col_tile, rows_padded_to=_SLAB, quantile=1.0,
    )
    if ovw:
        raise RuntimeError(f"a quantile-1.0 payload overflowed ({ovw} slots)")
    if exact:  # the high half of each float32, in one strided copy
        td = np.ascontiguousarray(td.view(np.uint16)[:, _HIGH_HALF::2])
    return td, tl.astype(np.int16), wt, nt


def _widen(td: torch.Tensor, tl: torch.Tensor, exact: bool):
    """Wire format on the device -> the densify kernel's float32 values
    and int32 ids."""

    if exact:
        td = td.view(torch.bfloat16).float()
    return td, tl.int()


def _accum_slab(G, td, tl, *, wt, ntiles, ct, exact):
    """One slab step: densify, ``G += D D^T`` in place, and the slab's
    per-column sums and squared sums (float32; accumulated in float64 on
    the host). bf16-exact slabs densify to bf16 and multiply with a
    float32 result (exact products); others densify to float32 and
    multiply in full float32."""

    td, tl = _widen(td, tl, exact)
    if exact:
        D = tiled_ell_densify_t(
            td, tl, wt=wt, ntiles=ntiles, col_tile=ct, out_dtype=torch.bfloat16,
        )
        if D.device.type == "cuda" and _bf16_mm_f32():
            G += torch.mm(D, D.T, out_dtype=torch.float32)
            x = D.float()
        else:
            x = D.float()
            G.addmm_(x, x.T)
    else:
        x = tiled_ell_densify_t(
            td, tl, wt=wt, ntiles=ntiles, col_tile=ct, out_dtype=torch.float32,
        )
        G.addmm_(x, x.T)
    return x.sum(dim=1), (x * x).sum(dim=1)


def _project_slab(td, tl, Vp, corr, *, wt, ntiles, ct, exact):
    """One slab projection ``D^T V - 1 corr^T`` ([8192, k]) in float32."""

    td, tl = _widen(td, tl, exact)
    D = tiled_ell_densify_t(
        td, tl, wt=wt, ntiles=ntiles, col_tile=ct, out_dtype=torch.float32,
    )
    return D.T @ Vp - corr[None, :]


def _accum_graph_mesh(G, tds, tls, mesh, *, wt, ntiles, ct, exact):
    """One super-slab step over a mesh: slab ``d`` (``tds[d]``/``tls[d]``,
    on ``mesh.devices[d]``) densified and contracted on its device, the
    partial Grams and moment vectors added on the home device in slab
    order, then added into ``G`` there. -> the super-slab's moments."""

    from ..parallel.sharded import _psum

    home = mesh.home
    moments = []

    def partial_grams():
        for td, tl in zip(tds, tls):
            Gp = torch.zeros_like(G, device=td.device)
            moments.append(_accum_slab(Gp, td, tl, wt=wt, ntiles=ntiles, ct=ct, exact=exact))
            yield Gp
            del Gp  # before the next slab's is made

    G += _psum(partial_grams(), home)
    return _psum((s for s, _ in moments), home), _psum((sq for _, sq in moments), home)


def _project_graph_mesh(tds, tls, Vp, corr, mesh, *, wt, ntiles, ct, exact):
    """Super-slab projection over a mesh -> ``[len(tds) * 8192, k]`` on the
    home device (``Vp``/``corr`` there, copied once to each distinct
    device)."""

    from ..parallel.sharded import _replicas

    vreps, creps = _replicas(Vp, mesh), _replicas(corr, mesh)
    home = mesh.home
    return torch.cat([
        _project_slab(td, tl, vreps[td.device], creps[td.device], wt=wt, ntiles=ntiles, ct=ct,
                      exact=exact).to(home)
        for td, tl in zip(tds, tls)
    ])


class StreamingSparsePCA:
    """Exact out-of-core PCA over row-slab streams of a CSR matrix.

    Usage::

        pca = StreamingSparsePCA(n_components=50, n_features=30000)
        for chunk in chunks:          # scipy.sparse CSR row slabs
            pca.partial_fit(chunk)
        pca.finalize()
        for chunk in chunks:
            scores = pca.transform(chunk)

    State after ``finalize``: ``components_`` (k x p) and ``mean_`` (p)
    on ``device``, ``explained_variance_`` (k, host float32) and
    ``total_variance_``. ``center=True`` gives true PCA; ``center=False``
    the truncated SVD of raw X. ``device`` is the card unless the caller
    names another. ``mesh`` (a ``parallel.Mesh``) spreads each step's
    slabs over the mesh's entries, one slab each (see the module docs);
    the Gram, the model and the scores then live on its home device
    (``device`` is ignored), and ``axis_name`` names its axis.
    """

    def __init__(
        self,
        n_components: int = 50,
        n_features: int | None = None,
        center: bool = True,
        random_seed: int = 42,
        col_tile: int = 256,
        mesh=None,
        axis_name: str = "rows",
        fold_every: int | None = None,
        payload_cache: dict | None = None,
        device="cuda",
    ):
        if n_features is None:
            raise ValueError("n_features (matrix width) is required")
        if n_features > 40960:
            raise ValueError(
                "streaming Gram PCA needs the p x p Gram on device; "
                f"p={n_features} > 40960"
            )
        if not 8 <= col_tile <= 32767:
            # wire-format local ids are int16 (see _slab_payload)
            raise ValueError(f"col_tile={col_tile} out of range [8, 32767]")
        self.n_components = n_components
        self.n_features = n_features
        self.center = center
        self.random_seed = random_seed
        self.ct = col_tile
        self.mesh = mesh
        self.axis_name = axis_name
        self.device = mesh.home if mesh is not None else torch.device(device)
        self.ntiles = max(-(-n_features // col_tile), 1)
        pp = self.ntiles * col_tile
        self._G = torch.zeros((pp, pp), dtype=torch.float32, device=self.device)
        self._sums = np.zeros(pp, np.float64)
        self._sumsq = np.zeros(pp, np.float64)
        self._n = 0
        # float32 accumulation of G over an unbounded slab count drifts
        # like eps * sqrt(n_slabs); every `fold_every` slabs the device G
        # is folded into a host float64 accumulator, bounding the drift to
        # one fold group. A fold pulls [pp, pp] to the host, so large
        # Grams fold less often.
        if fold_every is None:
            fold_every = 256 if pp <= 8192 else 2048
        self.fold_every = fold_every
        self._G64: Optional[np.ndarray] = None
        self._slabs_since_fold = 0
        # per-slab moment pulls wait in a short queue so the device stays
        # up to two slabs ahead of the host (the pull is the sync point)
        self._pending: list = []
        self._pipeline_depth = 2
        # caller-owned device-payload cache: partial_fit(chunk, key=...)
        # stores the uploaded slab payloads under the key, and a later
        # partial_fit with the same key skips the host build and the
        # upload. The caller promises key -> content stability.
        self._payloads = payload_cache
        # the randomized solve's sketch (pp > EIGH_MAX_PP) when not None:
        # the parity tests set it to the JAX package's
        self._omega: Optional[torch.Tensor] = None
        self.components_: Optional[torch.Tensor] = None
        self.explained_variance_: Optional[np.ndarray] = None
        self.mean_: Optional[torch.Tensor] = None
        self.total_variance_: Optional[float] = None

    def _drain_moments(self, keep: int = 0) -> None:
        """Pull queued per-slab moment vectors into the host float64
        accumulators, leaving at most ``keep`` slabs in flight."""

        while len(self._pending) > keep:
            s, sq = self._pending.pop(0)
            self._sums += s.cpu().numpy().astype(np.float64)
            self._sumsq += sq.cpu().numpy().astype(np.float64)

    def _fold_gram(self) -> None:
        """Fold the device float32 Gram into the host float64 accumulator
        and reset the device accumulator."""

        if self._slabs_since_fold == 0:
            return
        if self._G64 is None:
            self._G64 = np.zeros(tuple(self._G.shape), np.float64)
        self._G64 += self._G.cpu().numpy().astype(np.float64)
        self._G.zero_()
        self._slabs_since_fold = 0

    def _count_slabs(self, k: int) -> None:
        self._slabs_since_fold += k
        if self._slabs_since_fold >= self.fold_every:
            self._fold_gram()

    def _invalidate_solve(self) -> None:
        """New data after finalize(): the Gram is additive, so keep
        accumulating and drop the stale solve."""

        if self.components_ is not None:
            self.components_ = None
            self.explained_variance_ = None
            self.mean_ = None
            self.total_variance_ = None

    # -- accumulation ----------------------------------------------------

    def _iter_slabs(self, chunk):
        """Yield (indptr, indices, data, n_rows) 8192-row sub-slabs of a
        scipy CSR (or SparseMatrix) chunk."""

        from ..sparse.matrix import SparseMatrix

        if isinstance(chunk, SparseMatrix):
            chunk = chunk.to_scipy()
        chunk = chunk.tocsr()
        if chunk.shape[1] != self.n_features:
            raise ValueError(
                f"chunk width {chunk.shape[1]} != n_features {self.n_features}"
            )
        n = chunk.shape[0]
        for r0 in range(0, n, _SLAB):
            r1 = min(r0 + _SLAB, n)
            sl = chunk[r0:r1]
            yield (
                sl.indptr.astype(np.int64, copy=False),
                sl.indices.astype(np.int32, copy=False),
                sl.data.astype(np.float32, copy=False),
                r1 - r0,
            )

    def _built(self, chunk):
        """Host payloads ``(td, tl, wt, nt, n_rows, exact)`` of a chunk's
        slabs (run on the :func:`_prefetch` worker)."""

        for indptr, indices, data, n_rows in self._iter_slabs(chunk):
            exact = _bf16_exact(data)
            td, tl, wt, nt = _slab_payload(
                indptr, indices, data, n_rows, self.n_features, self.ct,
                exact=exact,
            )
            yield td, tl, wt, nt, n_rows, exact

    def _iter_super_slabs(self, chunk):
        """Mesh mode: yield ``(tds, tls, wt, ntiles, n_rows, exact,
        n_real)`` per group of up to ``ndev`` consecutive slabs: each
        slab's wire payload padded to the group's widest ``wt`` (the JAX
        package's uniform super-slab; padding slots are zeros), the
        exactness decided for the whole group first, ``n_real`` the
        group's slabs (run on the :func:`_prefetch` worker)."""

        ndev = self.mesh.shape[self.axis_name]
        slabs = list(self._iter_slabs(chunk))
        for g0 in range(0, len(slabs), ndev):
            group = slabs[g0:g0 + ndev]
            exact = all(_bf16_exact(data) for _, _, data, _ in group)
            parts = [_slab_payload(ip, ix, data, nr, self.n_features, self.ct, exact=exact)
                     for ip, ix, data, nr in group]
            wt = max(8, *(w for _, _, w, _ in parts))
            nt = parts[0][3]
            tds, tls = [], []
            for td, tl, w, _ in parts:
                pad = ((0, 0), (0, wt - w), (0, 0))
                tds.append(np.pad(td.reshape(nt, w, _SLAB), pad).reshape(nt * wt, _SLAB))
                tls.append(np.pad(tl.reshape(nt, w, _SLAB), pad).reshape(nt * wt, _SLAB))
            yield tds, tls, wt, nt, sum(g[3] for g in group), exact, len(group)

    def _uploaded(self, chunk):
        """The chunk's slab payloads, built on the :func:`_prefetch` worker
        and uploaded: ``(td, tl, wt, nt, n_rows, exact)`` per slab, or in
        mesh mode ``(tds, tls, wt, nt, n_rows, exact, n_real)`` per
        super-slab, slab d on mesh entry d."""

        def put(td, tl, exact, dev):
            return (torch.from_numpy(td.view(np.int16) if exact else td).to(dev),
                    torch.from_numpy(tl).to(dev))

        if self.mesh is None:
            for td, tl, wt, nt, n_rows, exact in _prefetch(self._built(chunk)):
                yield (*put(td, tl, exact, self.device), wt, nt, n_rows, exact)
            return
        for tds, tls, wt, nt, n_rows, exact, n_real in _prefetch(self._iter_super_slabs(chunk)):
            wire = [put(td, tl, exact, dev) for td, tl, dev in zip(tds, tls, self.mesh.devices)]
            yield (tuple(w[0] for w in wire), tuple(w[1] for w in wire), wt, nt, n_rows, exact,
                   n_real)

    def _accum_entry(self, td_dev, tl_dev, wt, nt, n_rows, exact, n_real=1):
        """Accumulate one device-resident slab payload (mesh mode: a
        super-slab, per-entry payload tuples) into G / moments."""

        if self.mesh is not None:
            s, sq = _accum_graph_mesh(self._G, td_dev, tl_dev, self.mesh, wt=wt, ntiles=nt,
                                      ct=self.ct, exact=exact)
        else:
            s, sq = _accum_slab(
                self._G, td_dev, tl_dev, wt=wt, ntiles=nt, ct=self.ct, exact=exact,
            )
        self._pending.append((s, sq))
        self._n += n_rows
        # real slabs only: the fold bounds float32 rounding, which a
        # missing (padding) slab does not add
        self._count_slabs(n_real)
        self._drain_moments(self._pipeline_depth)

    @precision_policy()
    def partial_fit(self, chunk, *, key=None) -> "StreamingSparsePCA":
        """Accumulate one CSR row chunk (any row count) into the Gram and
        the column moments. Legal after ``finalize()`` too: new data drops
        the solved state until the next ``finalize()``.

        ``key`` (with a ``payload_cache`` dict passed at construction)
        caches the uploaded slab payloads under ``("1dev", key,
        col_tile)`` (``"mesh"`` in mesh mode): repeated passes over
        unchanged chunks skip the host build and the upload."""

        self._invalidate_solve()
        cache = self._payloads
        ck = ("mesh" if self.mesh is not None else "1dev", key, self.ct)
        if cache is not None and key is not None and ck in cache:
            for entry in cache[ck]:
                self._accum_entry(*entry)
            return self
        store = [] if (cache is not None and key is not None) else None
        for entry in self._uploaded(chunk):
            if store is not None:
                store.append(entry)
            self._accum_entry(*entry)
        if store is not None:
            cache[ck] = store
        return self

    # -- solve -----------------------------------------------------------

    def refit(self, n_components: int | None = None) -> "StreamingSparsePCA":
        """Re-solve from the accumulated Gram at a (possibly different)
        component count: the p-space solve only, no pass over the data."""

        if n_components is not None:
            self.n_components = n_components
        self.components_ = None
        return self.finalize()

    @precision_policy()
    def finalize(self) -> "StreamingSparsePCA":
        if self._n < 2:
            raise RuntimeError("need at least 2 accumulated rows")
        self._drain_moments(0)
        p = self.n_features
        mean64 = self._sums / self._n
        self.mean_ = torch.as_tensor(mean64[:p].astype(np.float32), device=self.device)
        mu_p = torch.as_tensor(mean64.astype(np.float32), device=self.device)
        if self._G64 is not None:
            # close the open fold group and solve on the float64 Gram,
            # rounded once to float32
            self._fold_gram()
            G_solve = torch.as_tensor(self._G64.astype(np.float32), device=self.device)
        else:
            G_solve = self._G
        s, vt = solve_gram_topk(
            G_solve, mu_p, self._n, self.random_seed,
            k=self.n_components, center=self.center, omega=self._omega,
        )
        s_np = s.cpu().numpy().astype(np.float64)
        self.components_ = vt[:, :p]
        self.explained_variance_ = (s_np**2 / (self._n - 1)).astype(np.float32)
        if self.center:
            self.total_variance_ = float(
                np.sum((self._sumsq - mean64 * self._sums) / (self._n - 1))
            )
        else:
            self.total_variance_ = float((s_np**2).sum() / (self._n - 1))
        return self

    # -- inference -------------------------------------------------------

    @precision_policy()
    def inverse_transform(self, T) -> np.ndarray:
        """Back-project scores: ``T @ components_`` (+ ``mean_`` when
        centered)."""

        if self.components_ is None:
            raise RuntimeError("Must be fitted before transform!")
        R = torch.as_tensor(np.asarray(T), dtype=torch.float32,
                            device=self.device) @ self.components_
        if self.center:
            R = R + self.mean_
        return R.cpu().numpy()

    @precision_policy()
    def transform(self, chunk) -> np.ndarray:
        """Project one CSR row chunk -> host scores [chunk_rows, k]."""

        if self.components_ is None:
            raise RuntimeError("Must be fitted before transform!")
        pp = self._G.shape[0]
        k = self.components_.shape[0]
        Vp = torch.zeros((pp, k), dtype=torch.float32, device=self.device)
        Vp[: self.n_features] = self.components_.T.float()
        if self.center:
            corr = self.mean_ @ self.components_.T
        else:
            corr = torch.zeros(k, dtype=torch.float32, device=self.device)
        # a small window of slab projections in flight: the host build
        # overlaps the device work, and draining the oldest bounds device
        # memory to a few slabs whatever the chunk's size
        outs: list = []
        handles: list = []

        def drain(keep):
            while len(handles) > keep:
                T, nr = handles.pop(0)
                outs.append(T[:nr].cpu().numpy())

        for td, tl, wt, nt, n_rows, exact, *_ in self._uploaded(chunk):
            kw = dict(wt=wt, ntiles=nt, ct=self.ct, exact=exact)
            if self.mesh is not None:
                T = _project_graph_mesh(td, tl, Vp, corr, self.mesh, **kw)
            else:
                T = _project_slab(td, tl, Vp, corr, **kw)
            handles.append((T, n_rows))
            drain(self._pipeline_depth)
        drain(0)
        return np.concatenate(outs, axis=0)

    # -- streaming statistics byproducts ---------------------------------

    def col_sums(self) -> np.ndarray:
        """Accumulated float64 column sums (streaming ``sum_col_chunk``)."""

        if self._n < 1:
            raise RuntimeError("no rows accumulated yet")
        self._drain_moments(0)
        return self._sums[: self.n_features].copy()

    def col_sums_squared(self) -> np.ndarray:
        if self._n < 1:
            raise RuntimeError("no rows accumulated yet")
        self._drain_moments(0)
        return self._sumsq[: self.n_features].copy()

    def col_var(self) -> np.ndarray:
        """Bessel-corrected column variance over all accumulated rows
        (implicit zeros included: ``var_col`` semantics)."""

        n = self._n
        if n < 2:
            raise RuntimeError("need at least 2 accumulated rows for a variance")
        self._drain_moments(0)
        mean = self._sums / n
        return ((self._sumsq - mean * self._sums) / (n - 1))[: self.n_features]
