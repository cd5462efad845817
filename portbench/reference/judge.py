"""The comparison that decides ``correct``: the numbers, from the plain
reference (``pca64``) in float64, for what a side produced.

A side is the program's timed path, or the control put in its place.
Each side output is a dict with ``ev`` (explained variances, host),
``vt`` (components ``[k, p_cols]``), ``t`` (scores ``[n, k]``), and for
the same-sketch kind ``seed`` (the fit's ``random_seed``). The reference
reads them only to judge them.

Numbers (each the worst over the side's outputs):

* ``ev_gap``: max over components of |ev - ev_ref| / ev_ref[0].
* ``ev_gap_mean``: the mean over components of the same gaps (steadier
  from seed to seed than the widest one, which one component can set).
* ``vec_resid`` (exact solves): max over components of
  ``||G v - (v^T G v) v|| / lambda_1`` for the reference's float64 Gram
  ``G`` (centered when the solve is) and the side's unit vector ``v``.
* ``vec_gap`` (randomized solves): max over components of the distance of
  the side's unit vector to the same-sketch float64 vector, sign aside;
  ``vec_gap_mean`` the mean of those distances.
* ``score_gap``: max |t - t_ref| / max |t_ref|, ``t_ref`` the float64
  scores of the side's own components, centered by the reference's mean.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pca64

__all__ = ["judge", "judge_each"]


def _unit_rows(vt) -> torch.Tensor:
    v = vt.double()
    return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)


def _score_gap(A: pca64.Csr, mu, out) -> float:
    t_ref = pca64.project(A, mu, out["vt"].to(A.device).double())
    t = out["t"].to(A.device).double()
    return float((t - t_ref).abs().max() / t_ref.abs().max())


def _exact_eig(A: pca64.Csr, mu, outs, k: int, center: bool):
    n = A.shape[0]
    G = pca64.gram(A)
    if center:
        G.addr_(mu, mu, alpha=-n)
    lam, _, _ = pca64.top_eig(G, k)
    ev_ref = (lam / (n - 1)).cpu().numpy()
    nums = []
    for out in outs:
        ev = np.asarray(out["ev"], np.float64)
        V = _unit_rows(out["vt"].to(A.device)).T
        GV = G @ V
        q = (V * GV).sum(dim=0)
        resid = torch.linalg.vector_norm(GV - V * q[None, :], dim=0) / lam[0]
        nums.append({"ev_gap": float(np.abs(ev - ev_ref).max() / ev_ref[0]),
                     "ev_gap_mean": float(np.abs(ev - ev_ref).mean() / ev_ref[0]),
                     "vec_resid": float(resid.max()),
                     "score_gap": _score_gap(A, mu, out)})
    return nums


def _same_sketch(A: pca64.Csr, mu, outs, k: int, oversamples: int, iters: int):
    n = A.shape[0]
    refs, nums = {}, []
    for out in outs:
        if out["seed"] not in refs:
            refs[out["seed"]] = pca64.randomized_svd(A, mu, k, oversamples, iters, out["seed"])
        s, vt_ref = refs[out["seed"]]
        ev_ref = (s * s / (n - 1)).cpu().numpy()
        ev = np.asarray(out["ev"], np.float64)
        v = _unit_rows(out["vt"].to(A.device))
        r = _unit_rows(vt_ref)
        gap = torch.minimum(torch.linalg.vector_norm(v - r, dim=1),
                            torch.linalg.vector_norm(v + r, dim=1))
        nums.append({"ev_gap": float(np.abs(ev - ev_ref).max() / ev_ref[0]),
                     "ev_gap_mean": float(np.abs(ev - ev_ref).mean() / ev_ref[0]),
                     "vec_gap": float(gap.max()),
                     "vec_gap_mean": float(gap.mean()),
                     "score_gap": _score_gap(A, mu, out)})
    return nums


def judge_each(X, outs, *, config: dict, check: dict, device) -> list:
    """The compared numbers of each side output in ``outs`` (a list of
    dicts, in order) of a cell on the host CSR counts ``X``;
    ``check['kind']`` names the reference solve."""

    pca = config["pca"]
    k = int(pca["n_components"])
    A = pca64.Csr.from_scipy(X, device)
    mu = A.col_sums() / A.shape[0]
    if check["kind"] == "exact_eig":
        return _exact_eig(A, mu, outs, k, bool(check["center"]))
    if check["kind"] == "same_sketch":
        return _same_sketch(A, mu, outs, k, int(pca["n_oversamples"]),
                            int(pca["n_power_iterations"]))
    raise ValueError(f"unknown check kind {check['kind']!r}")


def judge(X, outs, **kw) -> dict:
    """The worst of each compared number over ``outs`` (see
    :func:`judge_each`)."""

    worst = {}
    for got in judge_each(X, outs, **kw):
        for name, v in got.items():
            worst[name] = max(worst.get(name, v), v)
    return worst
