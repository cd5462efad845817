"""``models/mnn.py`` of the torch port against the JAX package.

Both packages find the same mutual pairs (the cross-set kNN in float32);
the kernel-weighted corrections agree within 1e-5 of the largest
|coordinate| over one and two (the default) iterations. A third
iteration packs the batches so tightly that the float32 kNN's ~3e-5
rounding reorders near-tied 12th neighbors between the packages (one
pair of 1,374 differs), so three iterations are held by the planted
shift's bar of ``tests/test_mnn.py`` instead.
"""

import numpy as np
import pytest

from single_algebra_tpu.models import mnn as jmnn
from single_algebra_tpu_torch.metrics import adjusted_rand_index
from single_algebra_tpu_torch.models import MNNResult, mnn_correct
from single_algebra_tpu_torch.models import mnn as tmnn
from tests.test_mnn import _gap, _shifted_batches


def test_mnn_pairs_match_jax():
    Z, _, b = _shifted_batches(seed=1)
    R, B = Z[b == "b0"], Z[b == "b1"]
    got = tmnn._mnn_pairs(R, B, 10, device="cpu")
    want = jmnn._mnn_pairs(R, B, 10)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("n_batches", [2, 3])
def test_mnn_correct_matches_jax(iterations, n_batches):
    Z, _, b = _shifted_batches(n_per=80, n_batches=n_batches, seed=2)
    got = mnn_correct(Z, b, k=12, iterations=iterations, device="cpu")
    want = jmnn.mnn_correct(Z, b, k=12, iterations=iterations)
    assert isinstance(got, MNNResult)
    assert got.n_pairs == want.n_pairs and got.batch_order == want.batch_order
    err = np.abs(got.corrected - want.corrected).max() / np.abs(want.corrected).max()
    assert err <= 1e-5


def test_mnn_removes_the_planted_shift():
    Z, t_lab, b_lab = _shifted_batches()
    res = mnn_correct(Z, b_lab, k=15, iterations=3, device="cpu")
    before = _gap(Z, t_lab, b_lab, "b0", "b1")
    after = _gap(res.corrected, t_lab, b_lab, "b0", "b1")
    assert after < 0.25 * before, (before, after)
    np.testing.assert_array_equal(res.corrected[b_lab == "b0"], Z[b_lab == "b0"])
    from single_algebra_tpu_torch.models import KMeans

    km = KMeans(3, n_init=3, random_seed=0, device="cpu").fit(res.corrected)
    assert adjusted_rand_index(t_lab, km.labels_.numpy()) > 0.95


def test_single_batch_and_errors():
    Z, _, _ = _shifted_batches(n_per=20)
    res = mnn_correct(Z, ["a"] * len(Z), device="cpu")
    np.testing.assert_array_equal(res.corrected, Z)
    assert res.n_pairs == []
    with pytest.raises(ValueError, match="iterations"):
        mnn_correct(Z, ["a"] * len(Z), iterations=0, device="cpu")
    with pytest.raises(ValueError, match="batch length"):
        mnn_correct(Z, ["a"], device="cpu")
