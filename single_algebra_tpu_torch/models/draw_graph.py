"""Force-directed graph layout (ForceAtlas2): scanpy's ``tl.draw_graph``.

Counterpart of ``single_algebra_tpu/models/draw_graph.py``. The CPU
ecosystem runs ForceAtlas2 (Jacomy et al. 2014) through Gephi / fa2 with
Barnes-Hut repulsion, a pointer tree. As in the JAX package and the port's
t-SNE knn mode, the n-body repulsion here is EXACT over all pairs in
``[block, n]`` tiles (O(n^2) operations, O(block * n) memory, no
tree-approximation error), the edge attraction a gather over a flat,
src-sorted edge list and a segmented sum over each node's edges
(``torch.segment_reduce``: no float atomics, so repeated runs are bit for
bit equal), and ForceAtlas2's adaptive global speed / swinging controller
runs on the device with no host synchronisation. The JAX package runs the
iterations in ``lax.fori_loop`` chunks of ``dispatch_chunk``; here a
Python loop drives eager kernels, so ``dispatch_chunk`` is kept for
parity and changes nothing.

Force model (fa2 reference semantics):

- mass ``m_i = 1 + degree_i``,
- repulsion  ``F = scaling * m_i m_j / d^2 * (y_i - y_j)``,
- attraction ``F = w^delta * (y_j - y_i)`` (optionally ``/ m_i`` with
  ``outbound_attraction_distribution``; ``lin_log`` applies
  ``log(1 + d) / d``),
- gravity    ``g m_i`` toward the origin (``strong_gravity``: ``g m_i d``),
- adaptive speed: global swinging / traction controller with per-node
  displacement factor ``speed / (1 + sqrt(speed * swinging_i))``, with
  the JAX package's two stabilisers (efficiency capped at 1, each
  displacement at half the RMS radius).

**Departure from the JAX arithmetic: the repulsion tile.** The JAX package
forms ``d2 = |a|^2 + |b|^2 - 2 a.b`` by a GEMM and the force as
``sum_j w_ij * y_i - W @ y``. The layout's radius grows to ~10^4 (the
TPU run recorded 27,664 at 100 iterations), where float32 cancellation
leaves errors of order ``6e-8 * |y|^2`` (~45) in ``d2``: near pairs are
then clamped to 1e-9 and their ``1 / d2`` explodes. Since ``dim`` is 2 or
3, the port forms ``d2`` from the coordinate differences ``y_i - y_j``
directly, elementwise tile work that costs the card what the GEMM form
does, and the force ``y_i sum_j w_ij - W y`` in float64 (the tile's
weights cast once), where the cancellation of that form stays far below
float32 rounding. The sums (each node's repulsion and
attraction, the controller's swinging and traction totals, the RMS
radius) accumulate in float64 and round once to float32: the descent is
chaotic (one rounding difference spreads through the whole layout within
a few iterations), so the mesh mode and the single device must round
alike whatever their reduction order. At the tests' sizes the two
packages agree (float64 forces to 1e-10, float32 iterations to the
tests' stated bounds); on the card the smoke holds the float32 forces to
a float64 evaluation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import precision_policy

__all__ = ["draw_graph"]


def _edge_list(a, n: int):
    """Symmetric CSR -> padded flat edge list (src sorted for the
    segmented sum); padding edges sit at src ``n - 1`` with weight 0."""

    e = int(a.nnz)
    ep = max(-(-e // 4096) * 4096, 4096)
    src = np.full(ep, n - 1, np.int32)
    dst = np.zeros(ep, np.int32)
    val = np.zeros(ep, np.float32)
    src[:e] = np.repeat(np.arange(n, dtype=np.int32), np.diff(a.indptr).astype(np.int64))
    dst[:e] = a.indices.astype(np.int32)
    val[:e] = a.data
    return src, dst, val


def partition_edges_by_slab(src, dst, val, e_real: int, ndev: int, rs: int):
    """Split a src-SORTED flat edge list into per-device slabs of equal
    padded length (``[ndev, Es]`` arrays, ``Es`` a multiple of 1,024).
    Filler edges sit at each slab's LAST row (keeps the local src sorted)
    with val 0 (inert). Shared by the mesh modes of draw_graph and
    t-SNE."""

    bounds = np.searchsorted(src[:e_real], np.arange(ndev + 1) * rs)
    es_max = max(int(np.diff(bounds).max()), 1)
    es_pad = -(-es_max // 1024) * 1024
    e_src = np.empty((ndev, es_pad), np.int32)
    e_dst = np.zeros((ndev, es_pad), np.int32)
    e_val = np.zeros((ndev, es_pad), val.dtype)
    for dvc in range(ndev):
        lo, hi = int(bounds[dvc]), int(bounds[dvc + 1])
        e_src[dvc] = (dvc + 1) * rs - 1
        e_src[dvc, : hi - lo] = src[lo:hi]
        e_dst[dvc, : hi - lo] = dst[lo:hi]
        e_val[dvc, : hi - lo] = val[lo:hi]
    return e_src, e_dst, e_val


def _attraction(y, e_src, e_dst, e_val, lengths, src_mass, mean_mass, *, lin_log: bool,
                outbound: bool):
    """Edge attraction summed per src row: ``[len(lengths), dim]``.
    ``src_mass`` is each edge's source mass (``outbound`` only)."""

    diff = y[e_dst] - y[e_src]  # [E, dim]
    w = e_val
    if lin_log:
        d = torch.sqrt(torch.clamp((diff * diff).sum(dim=-1), min=1e-18))
        w = w * torch.log1p(d) / d
    if outbound:
        # fa2: divide by the source mass AND compensate globally by the
        # mean mass (outboundAttCompensation)
        w = w * mean_mass / src_mass
    return torch.segment_reduce((w[:, None] * diff).double(), "sum", lengths=lengths, axis=0,
                                unsafe=True).to(y.dtype)


def _repulsion(y_rows, y, col_mass, row0: int, block: int):
    """``sum_j m_j (y_i - y_j) / d2_ij`` for the rows ``y_rows`` (global
    rows ``row0 + i``) against every row of ``y``, in ``[block, len(y)]``
    tiles: ``d2`` from direct coordinate differences, the sums in float64
    (see the module docstring);
    self pairs and zero-mass columns add nothing."""

    rows, dim = y_rows.shape
    out = torch.empty_like(y_rows)
    rows64 = y_rows.double()
    y1 = torch.cat([y.double(), torch.ones_like(y[:, :1], dtype=torch.float64)], dim=1)
    for b0 in range(0, rows, block):
        b1 = min(b0 + block, rows)
        d2 = (y_rows[b0:b1, 0, None] - y[None, :, 0]).square_()
        for k in range(1, dim):
            dk = y_rows[b0:b1, k, None] - y[None, :, k]
            d2.addcmul_(dk, dk)
            del dk
        wgt = torch.div(col_mass[None, :], d2.clamp_(min=1e-9), out=d2)
        torch.diagonal(wgt, offset=row0 + b0).zero_()  # no self pairs
        # sum_j w_ij (y_i - y_j) = y_i sum_j w_ij - W y, in float64 (one
        # product with [y, 1]): exact enough that its cancellation stays
        # below float32 rounding
        wy = wgt.double() @ y1
        del d2, wgt
        out[b0:b1] = rows64[b0:b1] * wy[:, dim:] - wy[:, :dim]
    return out


def _gravity(y, mass, sq, *, scaling, gravity, strong_gravity: bool):
    """fa2's apply_gravity: the strong branch carries the scalingRatio
    coefficient, the linear branch does not."""

    if strong_gravity:
        return -scaling * gravity * mass[:, None] * y
    dist = torch.sqrt(torch.clamp(sq, min=1e-18))
    return -gravity * mass[:, None] * y / dist[:, None]


def _forces(y, mass, e_src, e_dst, e_val, *, scaling, gravity, strong_gravity: bool,
            lin_log: bool, outbound: bool, block: int, lengths=None):
    """Total ForceAtlas2 force field ``[n, dim]`` for positions ``y``.
    ``e_src`` must be sorted; ``lengths`` (each node's edge count) is
    computed from it when not given."""

    n = y.shape[0]
    if lengths is None:
        lengths = torch.bincount(e_src, minlength=n)
    src_mass = mass[e_src] if outbound else None
    mean_mass = float(mass.double().sum()) / n if outbound else None
    attr = _attraction(y, e_src, e_dst, e_val, lengths, src_mass, mean_mass, lin_log=lin_log,
                       outbound=outbound)
    rep = scaling * mass[:, None] * _repulsion(y, y, mass, 0, block)
    grav = _gravity(y, mass, (y * y).sum(dim=1), scaling=scaling, gravity=gravity,
                    strong_gravity=strong_gravity)
    return attr + rep + grav


def _forces_slab(y, mass_pad, y_sl, m_sl, r0: int, e_src, e_dst, e_val, lengths, *, scaling,
                 gravity, strong_gravity: bool, lin_log: bool, outbound: bool, block: int,
                 mean_mass):
    """ForceAtlas2 forces for one row slab ``[rs, dim]`` against the whole
    padded position array ``y`` ``[npad, dim]``: the per-slab body of the
    mesh mode. ``e_*`` are the slab's own edges (src in the slab, GLOBAL
    ids, ``lengths`` per slab row); ``r0`` the slab's first global row."""

    src_mass = None
    if outbound:
        # padded slab rows carry mass 0: their filler edges have w == 0, so
        # clamp the divisor to keep 0/0 out of the sum
        src_mass = torch.clamp(mass_pad[e_src], min=1.0)
    attr = _attraction(y, e_src, e_dst, e_val, lengths, src_mass, mean_mass, lin_log=lin_log,
                       outbound=outbound)
    rep = scaling * m_sl[:, None] * _repulsion(y_sl, y, mass_pad, r0, block)
    grav = _gravity(y_sl, m_sl, (y_sl * y_sl).sum(dim=1), scaling=scaling, gravity=gravity,
                    strong_gravity=strong_gravity)
    return attr + rep + grav


def _adjust_speed(swinging, traction, speed, speed_eff, jitter_tolerance, n_real: int):
    """fa2's global adaptive-speed controller on the mass-weighted totals
    -> ``(speed, speed_eff)``, 0-d tensors (no host synchronisation)."""

    est_jt = 0.05 * torch.sqrt(torch.tensor(float(n_real), dtype=swinging.dtype,
                                            device=swinging.device))
    jt = jitter_tolerance * torch.minimum(
        torch.maximum(est_jt * traction / float(n_real) ** 2, torch.sqrt(est_jt)),
        torch.full_like(est_jt, 10.0))
    high = swinging / traction > 2.0
    speed_eff = torch.where(high, torch.clamp(speed_eff * 0.5, min=0.05), speed_eff)
    jt = torch.where(high, torch.clamp(jt, min=jitter_tolerance), jt)
    target = jt * speed_eff * traction / swinging
    speed_eff = torch.where(
        swinging > jt * traction,
        torch.clamp(speed_eff * 0.7, min=0.05),
        torch.where(speed < 1000.0, speed_eff * 1.3, speed_eff),
    )
    # deviation from fa2 (the JAX package's): cap efficiency at its initial
    # value. fa2's 1.3x growth branch can compound unbounded once forces
    # align with gravity and swinging stays tiny
    speed_eff = torch.clamp(speed_eff, max=1.0)
    speed = speed + torch.minimum(target - speed, 0.5 * speed)
    return speed, speed_eff


def _displacement(f, swing_i, speed, rms):
    """Per-node step ``f * speed / (1 + sqrt(speed * swing_i))``, each
    bounded to half the RMS radius (the second stabiliser: one bad step
    cannot eject a node)."""

    disp = f * (speed / (1.0 + torch.sqrt(speed * swing_i)))[:, None]
    dnorm = torch.sqrt((disp * disp).sum(dim=1, keepdim=True))
    return disp * torch.clamp(0.5 * rms / torch.clamp(dnorm, min=1e-12), max=1.0)


def _total(x, dtype):
    """A controller total (swinging or traction): the float64 sum of ``x``
    (or ``x`` already summed), floored at 1e-12, in ``dtype``."""

    return torch.clamp(x.sum(dtype=torch.float64), min=1e-12).to(dtype)


def _rms(y, n: int):
    """The RMS radius of the ``n`` real rows of ``y`` (padding rows are 0)
    plus one, from a float64 sum."""

    return torch.sqrt((y * y).sum(dtype=torch.float64) / n).to(y.dtype) + 1.0


def _swing_traction(f, f_prev):
    """Per-node swinging and traction (the RAW per-node values; the
    controller's totals weight them by mass)."""

    return (torch.sqrt(((f - f_prev) ** 2).sum(dim=1)),
            0.5 * torch.sqrt(((f + f_prev) ** 2).sum(dim=1)))


def _fa2_chunk(state, mass, e_src, e_dst, e_val, i0: int, i1: int, scaling, gravity,
               jitter_tolerance, strong_gravity: bool, lin_log: bool, outbound: bool,
               block: int, lengths=None):
    """Iterations ``[i0, i1)`` of the FA2 descent from ``state = (y,
    f_prev, speed, speed_eff)`` -> the new state (the JAX ``_fa2_chunk``)."""

    y, f_prev, speed, speed_eff = state
    n = y.shape[0]
    if lengths is None:
        lengths = torch.bincount(e_src, minlength=n)
    for _ in range(i0, i1):
        f = _forces(y, mass, e_src, e_dst, e_val, scaling=scaling, gravity=gravity,
                    strong_gravity=strong_gravity, lin_log=lin_log, outbound=outbound,
                    block=block, lengths=lengths)
        swing_i, tract_i = _swing_traction(f, f_prev)
        swinging = _total(mass * swing_i, y.dtype)
        traction = _total(mass * tract_i, y.dtype)
        speed, speed_eff = _adjust_speed(swinging, traction, speed, speed_eff,
                                         jitter_tolerance, n)
        rms = _rms(y, n)
        y = y + _displacement(f, swing_i, speed, rms)
        f_prev = f
    return y, f_prev, speed, speed_eff


class _FA2Mesh:
    """The mesh mode's layout (the JAX ``_fa2_chunk_mesh``): row slab ``d``
    of ``rs`` rows (a multiple of ``block``; ``npad = ndev * rs``) owns the
    edges whose src lies in it and its masses; the padded positions and
    forces live whole on the home device and are copied to each distinct
    device every iteration (the JAX ``all_gather``)."""

    def __init__(self, src, dst, val, e_real: int, mass: np.ndarray, n: int, mesh,
                 repulsion_block: int, dtype=torch.float32):
        ndev = mesh.size
        rs = max(-(-n // ndev), 8)
        self.block = min(repulsion_block, max(rs // 8 // 8 * 8, 8))
        self.rs = rs = -(-rs // self.block) * self.block  # slab = whole blocks
        self.mesh, self.n = mesh, n
        es, ed, ev = partition_edges_by_slab(src, dst, val.astype(np.float32), e_real, ndev, rs)
        mass_pad = np.zeros(ndev * rs, np.float32)
        mass_pad[:n] = mass
        put = lambda a, dev, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
        self.mass_pad = {dev: put(mass_pad, dev, dtype) for dev in mesh.distinct}
        self.mean_mass = float(self.mass_pad[mesh.home].double().sum()) / n
        self.slabs = []
        for d, dev in enumerate(mesh.devices):
            lengths = np.bincount(es[d] - d * rs, minlength=rs)
            self.slabs.append((put(es[d], dev, torch.int64), put(ed[d], dev, torch.int64),
                               put(ev[d], dev, dtype), put(lengths, dev, torch.int64),
                               put(mass_pad[d * rs:(d + 1) * rs], dev, dtype)))

    @property
    def npad(self) -> int:
        return self.mesh.size * self.rs

    def run(self, state, i0: int, i1: int, scaling, gravity, jitter_tolerance, *,
            strong_gravity: bool, lin_log: bool, outbound: bool):
        from ..parallel.sharded import _psum, _replicas

        mesh, rs, home = self.mesh, self.rs, self.mesh.home
        y, f_prev, speed, speed_eff = state
        for _ in range(i0, i1):
            ys = _replicas(y, mesh)
            fs = _replicas(f_prev, mesh)
            parts = []
            for d, dev in enumerate(mesh.devices):
                es, ed, ev, lengths, m_sl = self.slabs[d]
                y_d = ys[dev]
                f_sl = _forces_slab(
                    y_d, self.mass_pad[dev], y_d[d * rs:(d + 1) * rs], m_sl, d * rs, es, ed, ev,
                    lengths, scaling=scaling, gravity=gravity, strong_gravity=strong_gravity,
                    lin_log=lin_log, outbound=outbound, block=self.block,
                    mean_mass=self.mean_mass)
                swing_i, tract_i = _swing_traction(f_sl, fs[dev][d * rs:(d + 1) * rs])
                parts.append((f_sl, swing_i, (m_sl * swing_i).sum(dtype=torch.float64),
                              (m_sl * tract_i).sum(dtype=torch.float64)))
            # the controller totals: one reduction each, in slab order
            swinging = _total(_psum((p[2] for p in parts), home), y.dtype)
            traction = _total(_psum((p[3] for p in parts), home), y.dtype)
            speed, speed_eff = _adjust_speed(swinging, traction, speed, speed_eff,
                                             jitter_tolerance, self.n)
            rms = _rms(y, self.n)
            new_y, new_f = [], []
            for d, dev in enumerate(mesh.devices):
                f_sl, swing_i = parts[d][0], parts[d][1]
                disp = _displacement(f_sl, swing_i, speed.to(dev), rms.to(dev))
                new_y.append((ys[dev][d * rs:(d + 1) * rs] + disp).to(home))
                new_f.append(f_sl.to(home))
            y, f_prev = torch.cat(new_y), torch.cat(new_f)
        return y, f_prev, speed, speed_eff


def _start(n: int, dim: int, seed: int, device) -> torch.Tensor:
    """The seeded random start: standard normal ``[n, dim]`` from a
    generator on ``device``, times sqrt(n)."""

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.randn((n, dim), generator=gen, dtype=torch.float32, device=device) * float(
        np.sqrt(n))


@precision_policy()
def draw_graph(
    adjacency,
    *,
    n_iter: int = 500,
    dim: int = 2,
    init=None,
    seed: int = 0,
    scaling: float = 2.0,
    gravity: float = 1.0,
    strong_gravity: bool = False,
    lin_log: bool = False,
    edge_weight_influence: float = 1.0,
    outbound_attraction_distribution: bool = False,
    jitter_tolerance: float = 1.0,
    repulsion_block: int = 2048,
    dispatch_chunk: int = 100,
    mesh=None,
    device="cuda",
) -> np.ndarray:
    """ForceAtlas2 layout of a (cell-cell) graph -> positions ``[n, dim]``.

    ``adjacency`` is a symmetric non-negative scipy sparse matrix or
    ``SparseMatrix``, typically :func:`neighbors.connectivities` output,
    the same graph ``cluster.leiden`` consumes (scanpy's ``pp.neighbors ->
    tl.draw_graph`` chain). ``init`` seeds positions (e.g. PAGA coarse
    positions indexed by cluster, or a prior layout); the default is a
    seeded random start (``torch.Generator``, so not the JAX package's
    draw). The layout runs on ``device`` (a ``SparseMatrix`` input's own
    device; the mesh's home device with ``mesh``). Returns a host numpy
    array.

    ``mesh``: a ``parallel.Mesh`` shards the O(n^2) repulsion and the edge
    attraction over row slabs (one reduction per controller total and one
    gather of the ``[n, dim]`` positions per iteration).
    """

    from ..cluster import _as_sym_csr

    a = _as_sym_csr(adjacency)
    n = a.shape[0]
    if n < 2:
        raise ValueError("graph needs at least 2 nodes")
    if n_iter < 1:
        raise ValueError(f"n_iter={n_iter} must be >= 1")
    if dim < 1:
        raise ValueError(f"dim={dim} must be >= 1")
    from ..sparse import SparseMatrix

    if mesh is not None:
        device = mesh.home
    elif isinstance(adjacency, SparseMatrix):
        device = adjacency.device
    device = torch.device(device)

    deg = np.asarray(a.getnnz(axis=1), np.float32)
    mass_h = (1.0 + deg).astype(np.float32)
    if edge_weight_influence == 0.0:
        w = np.ones_like(a.data)
    elif edge_weight_influence == 1.0:
        w = a.data
    else:
        w = np.power(a.data, edge_weight_influence)
    src, dst, val = _edge_list(a.__class__((w, a.indices, a.indptr), shape=a.shape), n)

    if init is not None:
        y0 = np.asarray(init, np.float32)
        if y0.shape != (n, dim):
            raise ValueError(f"init shape {y0.shape} != ({n}, {dim})")
        y0 = torch.from_numpy(np.ascontiguousarray(y0)).to(device)
    else:
        y0 = _start(n, dim, seed, device)
    del dispatch_chunk  # one eager loop (see the module docstring)

    one = torch.ones((), dtype=torch.float32, device=device)
    opts = dict(strong_gravity=strong_gravity, lin_log=lin_log,
                outbound=outbound_attraction_distribution)
    if mesh is not None:
        lay = _FA2Mesh(src, dst, val, int(a.nnz), mass_h, n, mesh, repulsion_block)
        yp = torch.zeros((lay.npad, dim), dtype=torch.float32, device=device)
        yp[:n] = y0
        state = (yp, torch.zeros_like(yp), one, one.clone())
        state = lay.run(state, 0, n_iter, float(scaling), float(gravity),
                        float(jitter_tolerance), **opts)
        return state[0][:n].cpu().numpy()

    block = min(repulsion_block, max(-(-n // 8) // 128 * 128, 128))
    mass = torch.from_numpy(mass_h).to(device)
    e_src = torch.from_numpy(src.astype(np.int64)).to(device)
    e_dst = torch.from_numpy(dst.astype(np.int64)).to(device)
    e_val = torch.from_numpy(val).to(device)
    state = (y0, torch.zeros_like(y0), one, one.clone())
    state = _fa2_chunk(state, mass, e_src, e_dst, e_val, 0, n_iter, float(scaling),
                       float(gravity), float(jitter_tolerance), block=block, **opts)
    return state[0].cpu().numpy()
