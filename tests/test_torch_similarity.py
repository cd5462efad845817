"""The port's similarity measures against the JAX package's: ``calculate``
and ``pairwise`` of the five measures on the same seeded embeddings, the
reference's Jaccard quirks, and the row-blocked path of the L1 / threshold
measures. Float32 results within 1e-6 absolute of JAX (all measures lie in
[0, 1], Jaccard's quirky ratio excepted, which counts exactly), float64
within 1e-12. Euclidean adds the rounding of its expansion
``|x|^2 + |y|^2 - 2<x, y>`` (both packages compute it): that difference
rounds at ~eps (|x|^2 + |y|^2), which moves the distance by at most
min(sqrt(that), that / (2 dist)), and the similarity by gamma times it —
large only for near-coincident pairs.
"""

import numpy as np
import pytest
import torch

import single_algebra_tpu.similarity as jsim
from single_algebra_tpu_torch import similarity as tsim

MEASURES = [
    ("CosineSimilarity", {}),
    ("EuclideanSimilarity", {"gamma": 0.3}),
    ("PearsonSimilarity", {}),
    ("ManhattanSimilarity", {"gamma": 0.05}),
    ("JaccardSimilarity", {}),
    ("JaccardSimilarity", {"threshold": 0.5}),
]


def pair(name, kw):
    return (getattr(tsim, name)(device="cpu", **kw), getattr(jsim, name)(**kw))


def embeddings(n, m, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(dtype)
    Y = rng.standard_normal((m, d)).astype(dtype)
    X[0] = 0.0  # a zero row: the zero-norm / empty-union guards
    X[1, : d // 2] = 0.0
    Y[2] = X[3]  # an exact duplicate: Jaccard's threshold counts equal entries
    return X, Y


def tol(dtype):
    return 1e-6 if dtype == np.float32 else 1e-12


def atol(name, kw, X, Y, dtype):
    """The bound of the module docs, per pair."""

    if name != "EuclideanSimilarity":
        return tol(dtype)
    X, Y = np.atleast_2d(X).astype(np.float64), np.atleast_2d(Y).astype(np.float64)
    dsq = 8 * np.finfo(dtype).eps * ((X * X).sum(1)[:, None] + (Y * Y).sum(1)[None, :])
    dist = np.sqrt(((X[:, None, :] - Y[None, :, :]) ** 2).sum(-1))
    ddist = np.minimum(np.sqrt(dsq), dsq / np.maximum(2 * dist, 1e-300))
    return tol(dtype) + kw.get("gamma", 1.0) * ddist


@pytest.mark.parametrize("name, kw", MEASURES, ids=[f"{n}{kw}" for n, kw in MEASURES])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pairwise_matches_jax(name, kw, dtype):
    X, Y = embeddings(23, 17, 9, dtype)
    t, j = pair(name, kw)
    got = t.pairwise(X, Y)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert np.all(np.abs(got.numpy() - np.asarray(j.pairwise(X, Y)))
                  <= atol(name, kw, X, Y, dtype))
    assert np.all(np.abs(t.pairwise(X).numpy() - np.asarray(j.pairwise(X)))
                  <= atol(name, kw, X, X, dtype))


@pytest.mark.parametrize("name, kw", MEASURES, ids=[f"{n}{kw}" for n, kw in MEASURES])
def test_calculate_matches_jax(name, kw):
    X, Y = embeddings(5, 5, 7, np.float64, seed=1)
    t, j = pair(name, kw)
    for a, b in ((X[0], Y[0]), (X[3], Y[2]), (X[1], X[4]), (X[2], X[2])):
        bound = float(np.max(atol(name, kw, a, b, np.float64)))
        assert abs(t.calculate(a, b) - j.calculate(a, b)) <= bound


def test_jaccard_quirks():
    """Equal positions (zeros included) are the intersection, positive
    positions the union, so the ratio can exceed 1; an empty union is 0."""

    t = tsim.JaccardSimilarity(device="cpu")
    a = np.array([0.0, 0.0, 1.0, -2.0])
    b = np.array([0.0, 0.0, 1.0, -2.0])
    assert t.calculate(a, b) == 4.0  # 4 equal positions / 1 positive one
    assert t.calculate(np.zeros(3), -np.ones(3)) == 0.0  # empty union
    assert t.calculate(a, b) == jsim.JaccardSimilarity().calculate(a, b)


@pytest.mark.parametrize("name", ["ManhattanSimilarity", "JaccardSimilarity"])
def test_blocked_path(monkeypatch, name):
    """The L1 / threshold measures run in row blocks bounded by ``_BLOCK``
    elements; a tiny budget (many blocks, a ragged last one) gives the
    one-block result exactly."""

    X, Y = embeddings(37, 11, 6, np.float32, seed=2)
    t, j = pair(name, {})
    whole = t.pairwise(X, Y)
    monkeypatch.setattr(tsim, "_BLOCK", 11 * 6 * 4)  # 4 rows a block
    assert tsim._block_rows(37, 11, 6) == 4
    blocked = t.pairwise(X, Y)
    torch.testing.assert_close(blocked, whole, rtol=0, atol=0)
    np.testing.assert_allclose(blocked.numpy(), np.asarray(j.pairwise(X, Y)), rtol=0, atol=1e-6)


def test_tensors_keep_their_device_and_numpy_goes_to_the_card():
    X = torch.from_numpy(embeddings(4, 4, 3, np.float32)[0])
    assert tsim.CosineSimilarity().pairwise(X).device == X.device
    assert tsim.CosineSimilarity().device == "cuda"  # numpy input's default
