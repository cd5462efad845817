"""t-SNE: exact and large-n (knn) modes in eager PyTorch.

Counterpart of ``single_algebra_tpu/models/tsne.py`` (see its module
docs). Two modes, both the standard recipe (van der Maaten & Hinton):
per-point perplexity calibration by bisection, symmetrized P, early
exaggeration, momentum descent with per-parameter gains on the
student-t Q.

- ``exact`` (n up to ``exact_max_n``): the ``[n, n]`` distances and
  affinities as dense tensors, two products an epoch.
- ``knn`` (large n): P restricted to each point's k nearest neighbors
  (k = 3 * perplexity) and symmetrized into a flat edge list; the
  attraction is a gather over the edges and a segmented sum over each
  point's edges (``torch.segment_reduce`` with lengths from the edge
  list's row counts: no float atomics, so repeated runs are bit for bit
  equal), the repulsion is EXACT over all pairs in ``[block, n]`` tiles
  (O(n^2) operations, O(block * n) memory). ``theta`` is kept for config
  parity and changes nothing.

The JAX package runs each mode as jitted programs; here a plain Python
loop over epochs drives eager kernels, so ``dispatch_chunk`` is kept for
config parity too. Gains, momentum and exaggeration switch at the
absolute epoch index. The public :func:`run` draws the start ``y0 = 1e-4
* N(0, 1)`` from a ``torch.Generator`` seeded with ``config.seed`` on the
run's device (the JAX package's PRNG cannot be reproduced); the private
``_run_exact`` / ``_run_knn`` take an explicit ``y0``. ``run(mesh=)``
shards the knn mode's rows over a ``parallel.Mesh`` (``_KnnMesh``,
``_descent_mesh``): its block size comes from the slab size, so a mesh
run is held against the JAX package's mesh run, not the single-device
one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..types import precision_policy

__all__ = ["TSNEConfig", "run", "run_f32", "run_f64"]


@dataclasses.dataclass(frozen=True)
class TSNEConfig:
    """Mirror of the reference config (``tsne/mod.rs:7-13``) and of the
    JAX package's knobs, field for field."""

    output_dim: int = 2
    perplexity: float = 30.0
    epochs: int = 1000
    theta: float = 0.5  # parity field; neither mode approximates

    learning_rate: float = 200.0
    early_exaggeration: float = 12.0
    exaggeration_epochs: int = 250
    initial_momentum: float = 0.5
    final_momentum: float = 0.8
    seed: int = 42

    # 'auto' picks 'exact' while n <= exact_max_n, else 'knn'
    mode: str = "auto"
    knn_k: int | None = None  # default 3 * perplexity (BH convention)
    exact_max_n: int = 16384
    repulsion_block: int = 2048
    dispatch_chunk: int = 50  # parity field: the JAX knn mode's epochs per dispatch


def _sq_dists(x: torch.Tensor) -> torch.Tensor:
    g = x @ x.T
    sq = torch.diagonal(g)
    d = sq[:, None] + sq[None, :] - 2.0 * g
    return torch.clamp(d, min=0.0)


def _bisect_beta(entropy_probs, n, target, dtype, device, iters):
    """Per-point bisection on beta = 1/(2 sigma^2) until the entropy hits
    ``target`` = log(perplexity); ``iters`` fixed steps, then the
    probabilities at the last beta."""

    beta = torch.ones(n, dtype=dtype, device=device)
    lo = torch.zeros(n, dtype=dtype, device=device)
    hi = torch.full((n,), float("inf"), dtype=dtype, device=device)
    for _ in range(iters):
        h, _ = entropy_probs(beta)
        too_high = h > target  # entropy too high -> increase beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, (lo + hi) / 2.0)
    return entropy_probs(beta)[1]


def _entropy(p: torch.Tensor) -> torch.Tensor:
    plogp = torch.where(p > 0, p * torch.log(p), torch.zeros((), dtype=p.dtype, device=p.device))
    return -plogp.sum(dim=1)


def _calibrate_p(d2: torch.Tensor, perplexity: float, iters: int = 50) -> torch.Tensor:
    """Conditional affinities ``P[j|i]`` of a full ``[n, n]`` squared
    distance matrix (self excluded), each row at the perplexity."""

    n = d2.shape[0]
    target = torch.log(torch.tensor(perplexity, dtype=d2.dtype, device=d2.device))
    eye = torch.eye(n, dtype=torch.bool, device=d2.device)
    d2m = d2.masked_fill(eye, float("inf"))

    def entropy_probs(beta):
        logits = -d2m * beta[:, None]
        logits = logits - logits.masked_fill(eye, float("-inf")).amax(dim=1, keepdim=True)
        w = torch.exp(logits).masked_fill_(eye, 0.0)
        sw = w.sum(dim=1, keepdim=True)
        p = w / torch.clamp(sw, min=1e-30)
        return _entropy(p), p

    return _bisect_beta(entropy_probs, n, target, d2.dtype, d2.device, iters)


def _calibrate_p_knn(d2: torch.Tensor, perplexity: float, iters: int = 50) -> torch.Tensor:
    """Conditional affinities over the k NEAREST-NEIGHBOR squared
    distances only (rows of ``d2 [n, k]``, self excluded): the Barnes-Hut
    sparsification of the input affinities. Rows sum to 1."""

    target = torch.log(torch.tensor(perplexity, dtype=d2.dtype, device=d2.device))

    def entropy_probs(beta):
        logits = -d2 * beta[:, None]
        logits = logits - logits.amax(dim=1, keepdim=True)
        w = torch.exp(logits)
        p = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-30)
        return _entropy(p), p

    return _bisect_beta(entropy_probs, d2.shape[0], target, d2.dtype, d2.device, iters)


def _descent(grad_fn, y0: torch.Tensor, config: TSNEConfig) -> torch.Tensor:
    """``config.epochs`` epochs of the early-exaggeration momentum descent
    with per-parameter gains from ``y0``, zero velocity and unit gains;
    the switches read the absolute epoch index ``i``."""

    y = y0
    vel = torch.zeros_like(y0)
    gains = torch.ones_like(y0)
    for i in range(config.epochs):
        early = i < config.exaggeration_epochs
        exag = config.early_exaggeration if early else 1.0
        momentum = config.initial_momentum if early else config.final_momentum
        g = grad_fn(y, exag)
        same_sign = (g > 0) == (vel > 0)
        gains = torch.clamp(torch.where(same_sign, gains * 0.8, gains + 0.2), min=0.01)
        vel = momentum * vel - config.learning_rate * gains * g
        y = y + vel
        y = y - y.mean(dim=0, keepdim=True)
    return y


# -- exact mode -------------------------------------------------------------


def _exact_affinities(x: torch.Tensor, config: TSNEConfig) -> torch.Tensor:
    """The symmetrized ``[n, n]`` P of the exact mode, floored at 1e-12."""

    n = x.shape[0]
    p_cond = _calibrate_p(_sq_dists(x), config.perplexity)
    p = (p_cond + p_cond.T) / (2.0 * n)
    return torch.clamp(p, min=1e-12)


def _exact_grad(y: torch.Tensor, p: torch.Tensor, exaggeration) -> torch.Tensor:
    """``dC/dy`` of the exact mode: ``4 sum_j (exag p_ij - q_ij) num_ij
    (y_i - y_j)`` with the student-t ``num = 1 / (1 + |y_i - y_j|^2)``."""

    num = 1.0 / (1.0 + _sq_dists(y))  # student-t kernel
    num.fill_diagonal_(0.0)
    q = num / torch.clamp(num.sum(), min=1e-12)
    q = torch.clamp(q, min=1e-12)
    pq = (exaggeration * p - q) * num  # [n, n]
    row = pq.sum(dim=1, keepdim=True) * y
    mix = pq @ y
    return 4.0 * (row - mix)


def _run_exact(x: torch.Tensor, config: TSNEConfig, y0: torch.Tensor) -> torch.Tensor:
    p = _exact_affinities(x, config)
    return _descent(lambda y, exag: _exact_grad(y, p, exag), y0, config)


# -- large-n ('knn') mode ---------------------------------------------------


def _symmetrize_knn(p_cond, idx, n):
    """Host-side setup: symmetrize the kNN conditional affinities into a
    FLAT edge list ``(src [E], dst [E], val [E])`` (CSR row order, so src
    is sorted) with ``P_sym[i, j] = (P[i|j] + P[j|i]) / (2n)``.

    A flat list, not a padded per-row layout: hub points of a
    high-dimensional kNN graph have 10-100x the median in-degree. The edge
    count is padded to a multiple of 4096 with val = 0 edges whose src is
    n - 1 (NOT 0), so src stays sorted through the padding."""

    import scipy.sparse as sp

    k = idx.shape[1]
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    P = sp.coo_matrix(
        (np.asarray(p_cond, np.float64).ravel(),
         (rows, np.asarray(idx, np.int64).ravel())),
        shape=(n, n),
    ).tocsr()
    S = ((P + P.T) / (2.0 * n)).tocsr()
    S.sum_duplicates()
    e = int(S.nnz)
    ep = max(-(-e // 4096) * 4096, 4096)
    src = np.full(ep, n - 1, np.int32)
    dst = np.zeros(ep, np.int32)
    val = np.zeros(ep, np.float64)
    lens = np.diff(S.indptr)
    src[:e] = np.repeat(np.arange(n, dtype=np.int32), lens)
    dst[:e] = S.indices.astype(np.int32)
    val[:e] = S.data
    return src, dst, val


def _knn_block(n: int, config: TSNEConfig) -> int:
    """Repulsion rows per tile, the JAX package's rule."""

    return min(config.repulsion_block, max(-(-n // 8) // 128 * 128, 128))


def _knn_grad(y, e_src, e_dst, e_val, exag, *, block: int, lengths=None):
    """Exact-gradient t-SNE step for sparse P: edge attraction by a
    segmented sum over each point's edges + BLOCKED exact repulsion
    (``[block, n]`` tiles).

    ``e_src`` must be sorted (CSR order, as :func:`_symmetrize_knn` gives
    it); ``lengths`` ([n], the edges of each point) is computed from it
    when not given. Deterministic: no float atomics anywhere."""

    n, dim = y.shape
    if lengths is None:
        lengths = torch.bincount(e_src, minlength=n)

    # attraction: sum_j p_ij num_ij (y_i - y_j) over stored edges
    diff = y[e_src] - y[e_dst]  # [E, dim]
    numa = 1.0 / (1.0 + (diff * diff).sum(dim=-1))  # [E]
    attr = torch.segment_reduce(
        (e_val * numa)[:, None] * diff, "sum", lengths=lengths, axis=0, unsafe=True,
    )  # [n, dim]; padded edges carry val == 0

    # repulsion: rep_i = (1/Z) sum_j num_ij^2 (y_i - y_j), Z = sum num
    sq = (y * y).sum(dim=1)
    rep = torch.empty_like(y)
    z = torch.zeros((), dtype=y.dtype, device=y.device)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        yb = y[r0:r1]
        num = sq[r0:r1, None] + sq[None, :]
        num.addmm_(yb, y.T, alpha=-2.0)  # squared distances
        num.clamp_(min=0.0).add_(1.0).reciprocal_()  # student-t kernel
        torch.diagonal(num, offset=r0).zero_()  # no self pairs
        z = z + num.sum()
        num.mul_(num)
        rep[r0:r1] = num.sum(dim=1, keepdim=True) * yb - num @ y
    rep = rep / torch.clamp(z, min=1e-12)
    return 4.0 * (exag * attr - rep)


def _knn_edges(x: torch.Tensor, config: TSNEConfig):
    """The symmetrized kNN affinities as a host edge list ``(src, dst,
    val)`` (:func:`_symmetrize_knn`'s): the kNN graph in float32 on x's
    device, the calibration in x's dtype, the symmetrization on the
    host."""

    from .umap import _knn_graph

    n = x.shape[0]
    k = config.knn_k or int(min(n - 1, round(3 * config.perplexity)))
    if k < config.perplexity:
        raise ValueError(
            f"knn_k={k} < perplexity={config.perplexity}: the entropy "
            "target is unreachable over so few neighbors"
        )
    d, idx = _knn_graph(x.float(), k=k, block=min(2048, max(8, n)))
    p_cond = _calibrate_p_knn(d.to(x.dtype) ** 2, config.perplexity)
    return _symmetrize_knn(p_cond.cpu().numpy(), idx.cpu().numpy(), n)


def _knn_affinities(x: torch.Tensor, config: TSNEConfig):
    """``(src, dst, val, lengths)`` of :func:`_knn_edges` on x's device."""

    src, dst, val = _knn_edges(x, config)
    src = torch.from_numpy(src.astype(np.int64)).to(x.device)
    dst = torch.from_numpy(dst.astype(np.int64)).to(x.device)
    val = torch.from_numpy(val).to(device=x.device, dtype=x.dtype)
    return src, dst, val, torch.bincount(src, minlength=x.shape[0])


# -- the knn mode over a mesh ------------------------------------------------


@dataclasses.dataclass
class _KnnMesh:
    """The knn mode's layout over a mesh (the JAX package's
    ``_knn_epoch_chunk_mesh``): row slab ``d`` of ``rs`` rows (``rs`` a
    multiple of ``block``; ``npad = ndev * rs``) owns the edges whose src
    lies in it (``es/ed/ev[d]``, with each row's edge count ``lengths[d]``
    for the segmented sum), its velocity and gains; y lives whole on the
    home device and is copied to each distinct device every epoch."""

    mesh: object
    n: int
    rs: int
    block: int
    es: tuple
    ed: tuple
    ev: tuple
    lengths: tuple

    @classmethod
    def build(cls, src, dst, val, n: int, mesh, config: TSNEConfig, dtype):
        from .draw_graph import partition_edges_by_slab

        ndev = mesh.size
        rs = max(-(-n // ndev), 8)
        block = min(config.repulsion_block, max(rs // 8 // 8 * 8, 8))
        rs = -(-rs // block) * block
        es, ed, ev = partition_edges_by_slab(src, dst, val, len(src), ndev, rs)
        out = ([], [], [], [])
        for d, dev in enumerate(mesh.devices):
            lengths = np.bincount(es[d] - d * rs, minlength=rs)
            for acc, a, dt in zip(out, (es[d], ed[d], ev[d], lengths),
                                  (torch.int64, torch.int64, dtype, torch.int64)):
                acc.append(torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dt))
        return cls(mesh, n, rs, block, *(tuple(a) for a in out))

    @property
    def npad(self) -> int:
        return self.mesh.size * self.rs

    def real_rows(self, d: int) -> torch.Tensor:
        """[rs, 1] bool: which of slab d's rows are real points."""

        r = d * self.rs + torch.arange(self.rs, device=self.mesh.devices[d])
        return (r < self.n)[:, None]


def _knn_grad_slab(y, y_sl, r0: int, e_src, e_dst, e_val, lengths, *, block: int,
                   n_real: int):
    """One slab's share of the knn-mode gradient: ``(attr, rep, z)`` with
    the attraction over the slab's src-local edges (segmented sum, no
    atomics), the unnormalized repulsion of its rows against all of y
    (padding columns, padding rows and self pairs masked) and its part of
    the student-t normalizer Z, which the caller reduces over the mesh."""

    rs = y_sl.shape[0]
    diff = y[e_src] - y[e_dst]
    numa = 1.0 / (1.0 + (diff * diff).sum(dim=-1))
    attr = torch.segment_reduce(
        (e_val * numa)[:, None] * diff, "sum", lengths=lengths, axis=0, unsafe=True,
    )  # [rs, dim]; filler edges carry val == 0

    sq = (y * y).sum(dim=1)
    rep = torch.empty_like(y_sl)
    z = torch.zeros((), dtype=y.dtype, device=y.device)
    for b0 in range(0, rs, block):
        b1 = min(b0 + block, rs)
        yb = y_sl[b0:b1]
        num = (yb * yb).sum(dim=1)[:, None] + sq[None, :]
        num.addmm_(yb, y.T, alpha=-2.0)  # squared distances
        num.clamp_(min=0.0).add_(1.0).reciprocal_()  # student-t kernel
        num[:, n_real:] = 0.0  # padding columns
        num[max(n_real - r0 - b0, 0):] = 0.0  # padding rows
        torch.diagonal(num, offset=r0 + b0).zero_()  # no self pairs
        z = z + num.sum()
        num.mul_(num)
        rep[b0:b1] = num.sum(dim=1, keepdim=True) * yb - num @ y
    return attr, rep, z


def _mesh_grads(lay: _KnnMesh, reps: dict, exag) -> list:
    """Each slab's gradient rows ``[rs, dim]`` on its device at the padded
    y held in ``reps`` (one copy per distinct device); Z is added over the
    slabs on the home device."""

    from ..parallel.sharded import _psum

    mesh, rs = lay.mesh, lay.rs
    terms = []
    for d, dev in enumerate(mesh.devices):
        y = reps[dev]
        terms.append(_knn_grad_slab(y, y[d * rs:(d + 1) * rs], d * rs, lay.es[d], lay.ed[d],
                                    lay.ev[d], lay.lengths[d], block=lay.block, n_real=lay.n))
    z = torch.clamp(_psum((t[2] for t in terms), mesh.home), min=1e-12)
    return [4.0 * (exag * attr - rep / z.to(attr.device)) for attr, rep, _ in terms]


def _knn_grad_mesh(lay: _KnnMesh, y: torch.Tensor, exag) -> torch.Tensor:
    """The whole mesh gradient at ``y`` ([n, dim] on the home device) ->
    [n, dim] there."""

    from ..parallel.sharded import _replicas

    yp = torch.zeros((lay.npad, y.shape[1]), dtype=y.dtype, device=y.device)
    yp[: lay.n] = y
    grads = _mesh_grads(lay, _replicas(yp, lay.mesh), exag)
    return torch.cat([g.to(y.device) for g in grads])[: lay.n]


def _descent_mesh(lay: _KnnMesh, y0: torch.Tensor, config: TSNEConfig) -> torch.Tensor:
    """:func:`_descent` over the mesh: velocity and gains per slab, y
    gathered on the home device each epoch, and the centering mean taken
    over the real rows (a reduction over the slabs); padding rows stay
    0."""

    from ..parallel.sharded import _psum, _replicas

    mesh, rs, n = lay.mesh, lay.rs, lay.n
    home = mesh.home
    y = torch.zeros((lay.npad, y0.shape[1]), dtype=y0.dtype, device=home)
    y[:n] = y0
    vel = [torch.zeros((rs, y0.shape[1]), dtype=y0.dtype, device=dev) for dev in mesh.devices]
    gains = [torch.ones_like(v) for v in vel]
    real = [lay.real_rows(d) for d in range(mesh.size)]
    for i in range(config.epochs):
        early = i < config.exaggeration_epochs
        exag = config.early_exaggeration if early else 1.0
        momentum = config.initial_momentum if early else config.final_momentum
        reps = _replicas(y, mesh)
        grads = _mesh_grads(lay, reps, exag)
        slabs = []
        for d, dev in enumerate(mesh.devices):
            g = grads[d]
            same_sign = (g > 0) == (vel[d] > 0)
            gains[d] = torch.clamp(torch.where(same_sign, gains[d] * 0.8, gains[d] + 0.2),
                                   min=0.01)
            vel[d] = momentum * vel[d] - config.learning_rate * gains[d] * g
            slabs.append(reps[dev][d * rs:(d + 1) * rs] + vel[d])
        mean = _psum((torch.where(real[d], s, 0.0).sum(dim=0) for d, s in enumerate(slabs)),
                     home) / float(n)
        y = torch.cat([torch.where(real[d], s - mean.to(s.device), 0.0).to(home)
                       for d, s in enumerate(slabs)])
    return y[:n]


def _run_knn(x: torch.Tensor, config: TSNEConfig, *, y0: torch.Tensor, mesh=None):
    if mesh is not None:
        src, dst, val = _knn_edges(x, config)
        lay = _KnnMesh.build(src, dst, val, x.shape[0], mesh, config, x.dtype)
        return _descent_mesh(lay, y0, config)
    src, dst, val, lengths = _knn_affinities(x, config)
    block = _knn_block(x.shape[0], config)

    def grad(y, exag):
        return _knn_grad(y, src, dst, val, exag, block=block, lengths=lengths)

    return _descent(grad, y0, config)


def _start(n: int, config: TSNEConfig, dtype, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(config.seed))
    return 1e-4 * torch.randn((n, config.output_dim), generator=gen, dtype=dtype,
                              device=device)


@precision_policy()
def run(x, config: TSNEConfig | None = None, *, mesh=None, device="cuda") -> torch.Tensor:
    """Embed rows of ``x`` [n, d] into ``config.output_dim`` dimensions on
    ``device`` (the card unless the caller names another).

    ``config.mode``: 'exact' (n x n affinities), 'knn' (sparse attraction
    + blocked exact repulsion, the large-n mode), or 'auto' (exact while
    ``n <= config.exact_max_n``). ``mesh`` (a ``parallel.Mesh``) shards
    the knn mode's rows over its entries (repulsion tiles and src-local
    attraction per slab, Z and the centering mean reduced on the home
    device, y gathered there each epoch); it forces 'knn' and puts the run
    on the mesh's home device."""

    if config is None:
        config = TSNEConfig()
    if mesh is not None:
        device = mesh.home
    x = torch.as_tensor(x, device=device)
    if not x.is_floating_point():
        x = x.float()
    if x.ndim != 2:
        raise ValueError(f"expected [n, d] input, got shape {tuple(x.shape)}")
    n = x.shape[0]
    if n <= config.perplexity * 3:
        raise ValueError(f"perplexity {config.perplexity} too large for n={n}")
    mode = config.mode
    if mode == "auto":
        mode = "exact" if n <= config.exact_max_n else "knn"
    if mesh is not None:
        mode = "knn"  # the sharded layout is the knn mode's formulation
    if mode not in ("exact", "knn"):
        raise ValueError(f"unknown t-SNE mode {config.mode!r}")
    y0 = _start(n, config, x.dtype, x.device)
    if mode == "exact":
        return _run_exact(x, config, y0)
    return _run_knn(x, config, y0=y0, mesh=mesh)


def run_f32(x, config: TSNEConfig | None = None, *, device="cuda") -> torch.Tensor:
    """Reference-parity alias (``tsne/mod.rs:15``)."""

    return run(torch.as_tensor(x, dtype=torch.float32), config, device=device)


def run_f64(x, config: TSNEConfig | None = None, *, device="cuda") -> torch.Tensor:
    """Reference-parity alias (``tsne/mod.rs:41``)."""

    return run(torch.as_tensor(x, dtype=torch.float64), config, device=device)
