"""raft_tpu_torch.stats against raft_tpu.stats on the CPU.

The same numpy inputs, made from a seed, go through both packages; results
agree within rtol 1e-5 / atol 1e-6 (integer counts exactly). The port counts
where the JAX package multiplies one-hot matrices (histogram, contingency,
class counts), takes the median of an even count as the mean of the two
middle values, and ranks trustworthiness' neighbours with a stable argsort
and ``select_k``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import stats as js
from raft_tpu_torch import stats as ts
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.stats import metrics as tmetrics

CPU = Resources(device="cpu")
RTOL, ATOL = 1e-5, 1e-6


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture
def rng():
    return np.random.default_rng(5)


@pytest.mark.parametrize("axis", [0, 1])
def test_moments(rng, axis):
    m = (rng.standard_normal((200, 6)) * 3 + 1).astype(np.float32)
    for sample in (False, True):
        close(ts.mean(m, axis, sample, res=CPU), js.mean(m, axis, sample))
        close(ts.vars_(m, axis=axis, sample=sample, res=CPU), js.vars_(m, axis=axis, sample=sample))
        close(ts.stddev(m, axis=axis, sample=sample, res=CPU),
              js.stddev(m, axis=axis, sample=sample))
        for g, w in zip(ts.meanvar(m, axis, sample, res=CPU), js.meanvar(m, axis, sample)):
            close(g, w)
    mu = m.mean(axis).astype(np.float32) + 0.5
    close(ts.vars_(m, mu, axis, res=CPU), js.vars_(m, mu, axis))
    close(ts.sum_(m, axis, res=CPU), js.sum_(m, axis), atol=1e-4)
    for g, w in zip(ts.minmax(m, axis, res=CPU), js.minmax(m, axis)):
        close(g, w)
    close(ts.mean_center(m, axis=axis, res=CPU), js.mean_center(m, axis=axis))
    close(ts.mean_add(m, mu, axis, res=CPU), js.mean_add(m, mu, axis))
    w = rng.random(m.shape[axis]).astype(np.float32)
    close(ts.weighted_mean(m, w, axis, res=CPU), js.weighted_mean(m, w, axis))


def test_cov(rng):
    m = rng.standard_normal((300, 7)).astype(np.float32) @ rng.standard_normal((7, 7)).astype(np.float32)
    for sample in (True, False):
        close(ts.cov(m, sample, res=CPU), js.cov(m, sample), atol=1e-5)


def test_histogram_counts_exactly(rng):
    m = rng.standard_normal((1_000, 5)).astype(np.float32)
    m[0] = -10.0                                  # clipped into bin 0
    m[1] = 10.0                                   # clipped into the last bin
    got = ts.histogram(m, 16, -2.0, 2.0, res=CPU)
    assert got.dtype == torch.int32 and tuple(got.shape) == (16, 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(js.histogram(m, 16, -2.0, 2.0)))
    assert int(got.sum()) == m.size
    v = m[:, 0].copy()
    np.testing.assert_array_equal(ts.histogram(v, 8, -1.0, 1.0, res=CPU).numpy(),
                                  np.asarray(js.histogram(v, 8, -1.0, 1.0)))
    with pytest.raises(RaftError, match="upper must exceed lower"):
        ts.histogram(m, 4, 1.0, 1.0, res=CPU)


def test_regression_metrics(rng):
    y = rng.standard_normal(500).astype(np.float32)
    y_hat = (y + 0.1 * rng.standard_normal(500)).astype(np.float32)
    close(ts.r2_score(y, y_hat, res=CPU), js.r2_score(y, y_hat))
    close(ts.accuracy(np.arange(10) % 3, np.arange(10) % 4, res=CPU),
          js.accuracy(np.arange(10) % 3, np.arange(10) % 4))
    for n in (500, 499):                          # even: two middle values averaged
        for g, w in zip(ts.regression_metrics(y_hat[:n], y[:n], res=CPU),
                        js.regression_metrics(y_hat[:n], y[:n])):
            close(g, w)
    # torch.median would return the lower middle value
    assert float(tmetrics._median(torch.tensor([1.0, 2.0, 4.0, 8.0]))) == 3.0


@pytest.fixture
def labels(rng):
    a = rng.integers(0, 6, 400).astype(np.int32)
    b = np.where(rng.random(400) < 0.7, a, rng.integers(0, 6, 400)).astype(np.int32)
    return a, b


def test_contingency_and_entropy(labels):
    a, b = labels
    got = ts.contingency_matrix(a, b, res=CPU)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(js.contingency_matrix(a, b)))
    np.testing.assert_array_equal(ts.contingency_matrix(a, b, 8, 7, res=CPU).numpy(),
                                  np.asarray(js.contingency_matrix(a, b, 8, 7)))
    # labels outside the classes count nowhere, as a one-hot row of zeros
    np.testing.assert_array_equal(ts.contingency_matrix(a, b, 4, 3, res=CPU).numpy(),
                                  np.asarray(js.contingency_matrix(a, b, 4, 3)))
    close(ts.entropy(a, 6, res=CPU), js.entropy(a, 6))
    close(ts.entropy(a, 9, res=CPU), js.entropy(a, 9))
    close(ts.entropy(np.zeros(5, np.int32), 3, res=CPU), js.entropy(np.zeros(5, np.int32), 3))


def test_cluster_comparison_metrics(labels):
    a, b = labels
    close(ts.mutual_info_score(a, b, 6, res=CPU), js.mutual_info_score(a, b, 6))
    close(ts.rand_index(a, b, res=CPU), js.rand_index(a, b))
    close(ts.adjusted_rand_index(a, b, res=CPU), js.adjusted_rand_index(a, b))
    close(ts.adjusted_rand_index(a, b, 7, res=CPU), js.adjusted_rand_index(a, b, 7))
    for name in ("homogeneity_score", "completeness_score", "v_measure"):
        close(getattr(ts, name)(a, b, 6, res=CPU), getattr(js, name)(a, b, 6))
    close(ts.v_measure(a, b, 6, beta=2.0, res=CPU), js.v_measure(a, b, 6, beta=2.0))
    one = np.zeros(50, np.int32)                  # H(C) = 0: homogeneity 1
    close(ts.homogeneity_score(one, a[:50], 6, res=CPU), js.homogeneity_score(one, a[:50], 6))


def test_kl_and_information_criterion(rng):
    p = rng.random(20).astype(np.float32)
    p[3] = 0.0
    p /= p.sum()
    q = rng.random(20).astype(np.float32)
    q[5] = 0.0
    q /= q.sum()
    close(ts.kl_divergence(p, q, res=CPU), js.kl_divergence(p, q))
    ll = np.float32(-123.5)
    for kind in ("aic", "aicc", "bic"):
        close(ts.information_criterion(ll, 7, 50, kind, res=CPU),
              js.information_criterion(ll, 7, 50, kind))
    with pytest.raises(RaftError, match="kind must be aic|aicc|bic"):
        ts.information_criterion(ll, 7, 50, "hqic", res=CPU)


def test_silhouette(rng):
    x = np.concatenate([rng.standard_normal((60, 4)), rng.standard_normal((50, 4)) + 4,
                        rng.standard_normal((1, 4)) - 6]).astype(np.float32)
    lab = np.array([0] * 60 + [1] * 50 + [3], np.int32)   # class 2 empty, class 3 alone
    for metric in ("euclidean", "l1"):
        close(ts.silhouette_score(x, lab, 4, metric, res=CPU),
              js.silhouette_score(x, lab, 4, metric), rtol=1e-5, atol=1e-6)


def test_dispersion(rng):
    c = rng.standard_normal((5, 3)).astype(np.float32)
    sizes = rng.integers(1, 50, 5).astype(np.float32)
    close(ts.dispersion(c, sizes, res=CPU), js.dispersion(c, sizes))
    g = np.ones(3, np.float32)
    close(ts.dispersion(c, sizes, g, res=CPU), js.dispersion(c, sizes, g))


def test_trustworthiness(rng):
    x = rng.standard_normal((120, 10)).astype(np.float32)
    proj = rng.standard_normal((10, 3)).astype(np.float32)
    e = x @ proj
    for k in (5, 12):
        close(ts.trustworthiness(x, e, k, res=CPU), js.trustworthiness(x, e, k))
    # ties in both spaces: duplicated rows, ranked by the lowest index in both
    xd = np.repeat(x[:40], 2, axis=0)
    ed = np.round(xd @ proj, 1).astype(np.float32)
    close(ts.trustworthiness(xd, ed, 6, res=CPU), js.trustworthiness(xd, ed, 6))
    with pytest.raises(RaftError, match="n_neighbors must be < n/2"):
        ts.trustworthiness(x[:10], e[:10], 5, res=CPU)


def test_embedding_knn_folds_negative_zero_like_jnp_argsort():
    """jnp.argsort ties -0 with +0 (lowest index first); the plain select
    route alone would rank -0 first, so the embedding's distances are folded
    to +0 before selection."""
    d = torch.tensor([[0.0, -0.0, 1.0, -0.0, 2.0], [3.0, 0.0, -0.0, 0.5, -0.0]])
    got = tmetrics._emb_knn(d, 3).numpy()
    want = np.asarray(jnp.argsort(jnp.asarray(d.numpy()), axis=1)[:, :3])
    np.testing.assert_array_equal(got, want)
