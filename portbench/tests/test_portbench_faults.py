"""The comparison sees a broken timed path. Each test skips the look for
a card and drives the rest of a run with the program broken underneath,
once for each fault these cells can have: an answer altered where it is
produced, and half of the rows left out of a reduction with the mean
taken over the rest. (A state returned unchanged is a training fault and
an exchange between chips a four-chip one: no cell here has either.)"""

import time

import numpy as np
import pytest
from conftest import TINY, tiny_cell

import single_algebra_tpu_torch.models.pca as pca
from portbench import harness


def _run(name):
    cell = tiny_cell(name)
    return harness.run_cell(cell, seed=2**32 + 5, seconds=0.1, trace=False, device="cpu",
                            t_start=time.perf_counter())


@pytest.mark.parametrize("name", sorted(TINY))
def test_an_altered_score_fails(name, monkeypatch):
    real = pca.SparsePCA.fit_transform

    def altered(self, *a, **kw):
        T = real(self, *a, **kw)
        T[T.shape[0] // 2, 0] += 1e-3 * float(T.abs().max())
        return T

    monkeypatch.setattr(pca.SparsePCA, "fit_transform", altered)
    result, checks = _run(name)
    assert not result["correct"]
    assert checks["score_gap"][0] > checks["score_gap"][1]


@pytest.mark.parametrize("name", sorted(TINY))
def test_an_altered_variance_fails(name, monkeypatch):
    real = pca._LazyPCAState._finalize_ev

    def altered(self):
        fresh = self._ev_np is None and self._s_dev is not None
        real(self)
        if fresh:
            self._ev_np = self._ev_np * np.float32(1 + 1e-3)

    monkeypatch.setattr(pca._LazyPCAState, "_finalize_ev", altered)
    result, checks = _run(name)
    assert not result["correct"]
    ev = "ev_gap" if "ev_gap" in checks else "ev_gap_mean"
    assert checks[ev][0] > checks[ev][1]


@pytest.mark.parametrize("name", sorted(TINY))
def test_half_the_rows_left_out_of_the_mean_fails(name, monkeypatch):
    real = pca._host_col_stats

    def half(m):
        s, sq = real(m)
        src = m._layout_for("row")
        cut = int(src._h_indptr[m.shape[0] // 2])
        data = src._csr_data_host()[:cut].astype(np.float64)
        idx = src._h_indices[:cut]
        s = 2 * np.bincount(idx, weights=data, minlength=m.ncols)[: m.ncols]
        sq = 2 * np.bincount(idx, weights=data * data, minlength=m.ncols)[: m.ncols]
        return s, sq

    monkeypatch.setattr(pca, "_host_col_stats", half)
    result, checks = _run(name)
    assert not result["correct"]
    assert checks["score_gap"][0] > checks["score_gap"][1]


def test_a_request_that_raises_is_counted(monkeypatch):
    real, calls = pca.SparsePCA.fit_transform, []

    def broken(self, *a, **kw):  # the warm-up request passes, the window's raise
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("broken on purpose")
        return real(self, *a, **kw)

    monkeypatch.setattr(pca.SparsePCA, "fit_transform", broken)
    result, _ = _run("counts-1Mx30k.fresh")
    assert result["failed"] == 1 and result["attempted"] == 1 and not result["correct"]
    assert "fresh_fit_s" not in result["metrics"]
