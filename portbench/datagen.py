"""Planted-cluster count matrices drawn from a seed, on several threads.

The recipe of ``benchmarks/_datagen.py::cluster_counts_big`` (64 planted
clusters, gamma rates scaled by ``geomspace(8, 1)``, rates calibrated so
the realised share of stored entries is ``density``, per cluster and
column a Binomial count of stored entries at uniform rows, values
``1 + Poisson(rate)``, duplicates summed, rows grouped by cluster),
frozen here so that the benchmark reads nothing outside its folder.

What differs: each cluster draws from its own generator, spawned from
the run's seed, so the clusters are drawn on a pool of threads (numpy's
generators and its sort release the interpreter lock), and each cluster's
block is built as CSR directly (one sort of packed keys) rather than
through a COO conversion of the whole matrix. The same seed gives the
same matrix whatever the number of threads.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp

__all__ = ["cluster_counts", "seed_sequence"]

_VALUE_BITS = 8  # a value 1 + Poisson(rate) rides in the low bits of its sort key


def seed_sequence(seed: int, *tags: int) -> np.random.SeedSequence:
    """The run's seed (any whole number) as a numpy seed sequence; ``tags``
    separate independent streams drawn from one seed."""

    return np.random.SeedSequence([int(seed) % (1 << 64), *tags])


def _cluster_rates(n_clusters: int, p: int, rng, density: float) -> np.ndarray:
    base = rng.gamma(2.0, 1.0, size=(n_clusters, p)) * (rng.random((n_clusters, p)) < 0.5)
    scale = np.geomspace(8, 1, n_clusters)[:, None]
    return base * scale * (density / max(base.mean(), 1e-9))


def _calibrate(lam: np.ndarray, density: float) -> np.ndarray:
    """Scale the rates so that the mean P(count >= 1) is ``density``."""

    lo, hi = 0.0, 1.0
    while np.mean(-np.expm1(-hi * lam)) < density:
        hi *= 2
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if np.mean(-np.expm1(-mid * lam)) < density:
            lo = mid
        else:
            hi = mid
    return lam * (0.5 * (lo + hi))


def _block(n_c: int, p: int, lam_c: np.ndarray, ss: np.random.SeedSequence):
    """One cluster's rows as (row lengths, column ids, values), CSR order
    with duplicates summed."""

    rng = np.random.default_rng(ss)
    counts = rng.binomial(n_c, -np.expm1(-lam_c))
    col_bits = max(int(p - 1).bit_length(), 1)
    key = np.repeat(np.arange(p, dtype=np.int64) << _VALUE_BITS, counts)
    key |= rng.integers(0, n_c, key.size, dtype=np.int64) << (col_bits + _VALUE_BITS)
    vals = rng.poisson(np.repeat(lam_c, counts)) + 1
    if vals.size and int(vals.max()) >= 1 << _VALUE_BITS:
        raise ValueError("a drawn value does not fit the packed sort key")
    key |= vals
    del vals
    key.sort()
    vals = key & ((1 << _VALUE_BITS) - 1)
    key >>= _VALUE_BITS
    first = np.empty(key.size, bool)
    first[:1] = True
    np.not_equal(key[1:], key[:-1], out=first[1:])
    if not first.all():  # an entry drawn twice: its values are summed
        starts = np.flatnonzero(first)
        vals = np.add.reduceat(vals, starts)
        key = key[starts]
    row_len = np.bincount(key >> col_bits, minlength=n_c)
    return row_len, (key & ((1 << col_bits) - 1)).astype(np.int32), vals.astype(np.float32)


def cluster_counts(n: int, p: int, *, seed: int, n_clusters: int = 64, density: float = 0.01,
                   threads: int | None = None) -> sp.csr_matrix:
    """An ``n x p`` float32 CSR count matrix with sorted indices, drawn
    from ``seed``."""

    root = seed_sequence(seed)
    rates_ss, *cluster_ss = root.spawn(n_clusters + 1)
    lam = _calibrate(_cluster_rates(n_clusters, p, np.random.default_rng(rates_ss), density)
                     .astype(np.float64), density)
    sizes = np.full(n_clusters, n // n_clusters, np.int64)
    sizes[: n % n_clusters] += 1
    workers = threads or min(n_clusters, os.cpu_count() or 1)
    with ThreadPoolExecutor(workers) as pool:
        blocks = list(pool.map(lambda c: _block(int(sizes[c]), p, lam[c], cluster_ss[c]),
                               range(n_clusters)))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.concatenate([b[0] for b in blocks]), out=indptr[1:])
    X = sp.csr_matrix((np.concatenate([b[2] for b in blocks]),
                       np.concatenate([b[1] for b in blocks]), indptr), shape=(n, p))
    X.has_sorted_indices = True
    return X
