"""``ingest.py`` of the torch port against the JAX package.

The cross-set kNN runs in float32 in both packages; the inverse-distance
weights and the vote are host float64: predicted labels are equal, the
confidences and transferred values agree within 1e-5 relative (the
float32 distances' rounding), and ``_weights`` within 1e-10 on the same
distances.
"""

import importlib

import numpy as np
import pytest

from single_algebra_tpu_torch import ingest, transfer_values

ji = importlib.import_module("single_algebra_tpu.ingest")
ti = importlib.import_module("single_algebra_tpu_torch.ingest")


def reference_and_query(n=300, d=6, k=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d)) * 4.0
    lab = rng.integers(0, k, 2 * n)
    X = (centers[lab] + rng.standard_normal((2 * n, d))).astype(np.float32)
    return X[:n], X[n:], np.asarray([f"t{c}" for c in lab[:n]]), lab[n:]


@pytest.mark.parametrize("k", [5, 15])
def test_ingest_matches_jax(k):
    R, Q, labels, truth = reference_and_query()
    got, conf = ingest(R, Q, labels, k=k, device="cpu")
    want, jconf = ji.ingest(R, Q, labels, k=k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(conf, jconf, rtol=1e-5)
    assert np.mean(got == np.asarray([f"t{c}" for c in truth])) > 0.95


@pytest.mark.parametrize("vec", [False, True])
def test_transfer_values_matches_jax(vec):
    R, Q, _, _ = reference_and_query(seed=1)
    V = R[:, :2] * 3.0 if vec else R[:, 0]
    got = transfer_values(R, Q, V, k=10, device="cpu")
    want = ji.transfer_values(R, Q, V, k=10)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_weights_and_exact_matches():
    d = np.abs(np.random.default_rng(2).standard_normal((20, 6)))
    d[3, 2] = 0.0
    np.testing.assert_allclose(ti._weights(d), ji._weights(d), rtol=1e-10)
    R, Q, labels, _ = reference_and_query(n=50, seed=3)
    got, conf = ingest(R, R[:7], labels, k=5, device="cpu")  # the reference's own rows
    np.testing.assert_array_equal(got, labels[:7])
    jgot, jconf = ji.ingest(R, R[:7], labels, k=5)
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_allclose(conf, jconf, rtol=1e-5)
    with pytest.raises(ValueError, match="labels length"):
        ingest(R, Q, labels[:-1], device="cpu")
    with pytest.raises(ValueError, match="values rows"):
        transfer_values(R, Q, np.ones(3), device="cpu")
