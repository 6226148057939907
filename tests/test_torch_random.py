"""raft_tpu_torch.random against raft_tpu.random on the CPU.

JAX's threefry and torch's generators never give the same bits, so draws
are held by distribution: at 100,000 draws from fixed seeds, each
distribution's mean and variance lie within 6 standard errors of its
closed form, a one-sample Kolmogorov-Smirnov test against the closed-form
CDF and a two-sample one against the JAX package's draws both give
p >= 1e-3. R-MAT's bit arithmetic is exact on a shared uniform draw; the
rest holds the JAX tests' properties.
"""

import math

import numpy as np
import pytest
import scipy.stats as sps
import torch

import jax
import jax.numpy as jnp

from raft_tpu import random as jr
from raft_tpu_torch import random as tr
from raft_tpu_torch.core import RaftError, Resources

CPU = Resources(device="cpu")
N_DRAWS = 100_000
EULER = 0.5772156649015329

# name: (kwargs, closed-form mean, variance, scipy distribution or None)
CONTINUOUS = {
    "uniform": (dict(low=2.0, high=4.0), 3.0, 4.0 / 12, sps.uniform(loc=2.0, scale=2.0)),
    "normal": (dict(mu=1.0, sigma=2.0), 1.0, 4.0, sps.norm(loc=1.0, scale=2.0)),
    "lognormal": (dict(mu=0.2, sigma=0.5), math.exp(0.2 + 0.125),
                  (math.exp(0.25) - 1) * math.exp(0.4 + 0.25),
                  sps.lognorm(s=0.5, scale=math.exp(0.2))),
    "gumbel": (dict(mu=1.0, beta=2.0), 1.0 + 2.0 * EULER, math.pi ** 2 * 4.0 / 6,
               sps.gumbel_r(loc=1.0, scale=2.0)),
    "logistic": (dict(mu=1.0, scale=2.0), 1.0, 4.0 * math.pi ** 2 / 3,
                 sps.logistic(loc=1.0, scale=2.0)),
    "exponential": (dict(lam=2.0), 0.5, 0.25, sps.expon(scale=0.5)),
    "rayleigh": (dict(sigma=2.0), 2.0 * math.sqrt(math.pi / 2), (4 - math.pi) / 2 * 4.0,
                 sps.rayleigh(scale=2.0)),
    "laplace": (dict(mu=1.0, scale=2.0), 1.0, 8.0, sps.laplace(loc=1.0, scale=2.0)),
}


def moments_ok(x, mean, var):
    x = np.asarray(x, np.float64)
    n = x.size
    se_mean = math.sqrt(var / n)
    se_var = np.std((x - x.mean()) ** 2) / math.sqrt(n)
    assert abs(x.mean() - mean) <= 6 * se_mean, (x.mean(), mean, se_mean)
    assert abs(x.var() - var) <= 6 * se_var, (x.var(), var, se_var)


@pytest.mark.parametrize("name", sorted(CONTINUOUS))
def test_continuous_distribution(name):
    kw, mean, var, dist = CONTINUOUS[name]
    got = getattr(tr, name)(tr.RngState(11), (N_DRAWS,), res=CPU, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (N_DRAWS,)
    got = got.numpy()
    assert np.isfinite(got).all()
    moments_ok(got, mean, var)
    assert sps.kstest(got, dist.cdf).pvalue >= 1e-3
    want = np.asarray(getattr(jr, name)(jr.RngState(11), (N_DRAWS,), **kw))
    assert sps.ks_2samp(got, want).pvalue >= 1e-3
    if name == "uniform":
        assert got.min() >= 2.0 and got.max() < 4.0


def test_discrete_distributions():
    b = tr.bernoulli(tr.RngState(1), (N_DRAWS,), prob=0.3, res=CPU)
    assert b.dtype == torch.bool
    moments_ok(b.numpy(), 0.3, 0.21)
    sb = tr.scaled_bernoulli(tr.RngState(2), (N_DRAWS,), prob=0.3, scale=2.0, res=CPU).numpy()
    assert set(np.unique(sb)) == {-2.0, 2.0}
    moments_ok(sb, 2.0 * (2 * 0.3 - 1), 4.0 * 4 * 0.3 * 0.7)
    jsb = np.asarray(jr.scaled_bernoulli(jr.RngState(2), (N_DRAWS,), prob=0.3, scale=2.0))
    assert set(np.unique(jsb)) == {-2.0, 2.0}
    ui = tr.uniform_int(tr.RngState(3), (N_DRAWS,), -3, 7, res=CPU)
    assert ui.dtype == torch.int32 and int(ui.min()) == -3 and int(ui.max()) == 6
    moments_ok(ui.numpy(), 1.5, (10 ** 2 - 1) / 12)
    w = np.array([0.0, 1.0, 3.0, 4.0])
    d = tr.discrete(tr.RngState(4), (N_DRAWS // 4, 4), w, res=CPU)
    assert d.dtype == torch.int32 and tuple(d.shape) == (N_DRAWS // 4, 4)
    d = d.numpy().ravel()
    assert (d > 0).all()
    jd = np.asarray(jr.discrete(jr.RngState(4), (N_DRAWS,), w))
    for c, p in ((1, 0.125), (2, 0.375), (3, 0.5)):
        se = math.sqrt(p * (1 - p) / N_DRAWS)
        assert abs((d == c).mean() - p) <= 6 * se
        assert abs((jd == c).mean() - p) <= 6 * se


def test_rng_state_streams():
    st = tr.RngState(3)
    a = tr.uniform(st, (10,), res=CPU)
    b = tr.uniform(st, (10,), res=CPU)
    assert not torch.equal(a, b)
    assert torch.equal(tr.uniform(tr.RngState(7), (10,), res=CPU),
                       tr.uniform(tr.RngState(7), (10,), res=CPU))
    fresh, skipped = tr.RngState(5), tr.RngState(5)
    for _ in range(3):
        third = tr.normal(fresh, (4,), res=CPU)
    skipped.advance(2)
    assert torch.equal(tr.normal(skipped, (4,), res=CPU), third)
    assert torch.equal(tr.uniform(9, (6,), res=CPU), tr.uniform(9, (6,), res=CPU))
    g = torch.Generator().manual_seed(1)
    assert tr.as_key(g, "cpu") is g
    with pytest.raises(RaftError, match="rng must be"):
        tr.as_key("seed", "cpu")


def test_permute_and_sampling():
    x = np.arange(40, dtype=np.float32).reshape(10, 4)
    out, perm = tr.permute(0, x, res=CPU)
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), x[perm.numpy()])
    assert sorted(perm.tolist()) == list(range(10))
    idx = tr.sample_without_replacement(1, 100, 50, res=CPU)
    assert idx.dtype == torch.int32 and len(np.unique(idx.numpy())) == 50
    assert int(idx.min()) >= 0 and int(idx.max()) < 100
    ex = tr.excess_subsample(2, 1000, 64, res=CPU).numpy()
    assert (np.diff(ex) > 0).all() and ex.max() < 1000
    with pytest.raises(RaftError, match="cannot sample 6 from 5"):
        tr.sample_without_replacement(0, 5, 6, res=CPU)


def test_weighted_sampling():
    w = np.ones(2_000)
    w[7] = 0.0
    w[1_000:1_200] = 0.0
    for seed in range(5):
        idx = tr.sample_without_replacement(seed, 2_000, 256, weights=w, res=CPU).numpy()
        assert len(np.unique(idx)) == 256
        assert 7 not in idx and not ((idx >= 1_000) & (idx < 1_200)).any()
    # heavier weights are drawn more often, as in the JAX package
    w = np.where(np.arange(100) < 50, 1.0, 9.0)
    got = np.concatenate([tr.sample_without_replacement(s, 100, 10, weights=w, res=CPU).numpy()
                          for s in range(200)])
    want = np.concatenate([np.asarray(jr.sample_without_replacement(s, 100, 10, weights=w))
                           for s in range(50)])
    p_port, p_jax = (got >= 50).mean(), (want >= 50).mean()
    se = math.sqrt(p_jax * (1 - p_jax) / want.size) + math.sqrt(p_port * (1 - p_port) / got.size)
    assert abs(p_port - p_jax) <= 6 * se, (p_port, p_jax)


def test_make_blobs():
    x, labels = tr.make_blobs(500, 8, n_clusters=5, seed=0, res=CPU)
    assert tuple(x.shape) == (500, 8) and labels.dtype == torch.int32
    assert set(np.unique(labels.numpy())) <= set(range(5))
    x, labels = tr.make_blobs(400, 4, n_clusters=3, cluster_std=0.01, seed=1, res=CPU)
    for lbl in range(3):
        pts = x.numpy()[labels.numpy() == lbl]
        if len(pts) > 1:
            assert np.std(pts, axis=0).max() < 0.1
    centers = np.array([[0.0, 0.0], [100.0, 100.0]], np.float32)
    x, labels = tr.make_blobs(2_000, 2, centers=centers, cluster_std=0.5, shuffle=False,
                              seed=2, res=CPU)
    x, labels = x.numpy(), labels.numpy()
    # every row within 6 std of its center in each coordinate; the noise is N(0, 0.25)
    assert (np.abs(x - centers[labels]) <= 6 * 0.5).all()
    moments_ok((x - centers[labels]).ravel(), 0.0, 0.25)
    jx, jlab = jr.make_blobs(2_000, 2, centers=centers, cluster_std=0.5, seed=2)
    assert sps.ks_2samp((x - centers[labels]).ravel(),
                        (np.asarray(jx) - centers[np.asarray(jlab)]).ravel()).pvalue >= 1e-3


@pytest.mark.parametrize("n_targets", [1, 3])
def test_make_regression(n_targets):
    x, y, coef = tr.make_regression(200, 5, n_informative=3, n_targets=n_targets, bias=2.0,
                                    seed=0, res=CPU)
    jx, jy, jc = jr.make_regression(200, 5, n_informative=3, n_targets=n_targets, bias=2.0)
    assert x.shape == jx.shape and y.shape == jy.shape and coef.shape == jc.shape
    c = coef.numpy()
    assert (c[3:] == 0).all() and (c[:3] >= 0).all() and (c[:3] < 100).all()
    pred = x.numpy() @ c + 2.0
    np.testing.assert_allclose(pred[:, 0] if n_targets == 1 else pred, y.numpy(),
                               rtol=1e-4, atol=1e-3)


def test_multi_variable_gaussian():
    mean = np.array([1.0, -2.0], np.float32)
    cov = np.array([[2.0, 0.6], [0.6, 1.0]], np.float32)
    s = tr.multi_variable_gaussian(0, mean, cov, 30_000, res=CPU).numpy()
    np.testing.assert_allclose(s.mean(0), mean, atol=0.05)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=0.1)
    with pytest.raises(RaftError, match=r"cov must be \(d, d\)"):
        tr.multi_variable_gaussian(0, mean, np.eye(3), 10, res=CPU)


@pytest.mark.parametrize("theta", [
    [9.0, 3.0, 3.0, 1.0],                                       # normalized by 16: exact
    np.tile(np.array([[0.25, 0.25, 0.25, 0.25], [0.5, 0.125, 0.25, 0.125]]), (6, 1)),
])
def test_rmat_bits_equal_jax_on_a_shared_draw(monkeypatch, theta):
    """Both packages' arithmetic on the same u (each package's uniform draw
    replaced by it) gives the same edges."""
    r_scale, c_scale, n_edges = 12, 9, 5_000
    u = np.random.default_rng(3).random((n_edges, 12)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(u))
    js, jd = jr.rmat(0, theta, r_scale, c_scale, n_edges)
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.from_numpy(u))
    ts, td = tr.rmat(0, theta, r_scale, c_scale, n_edges, res=CPU)
    assert ts.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_rmat_ranges_skew_and_checks():
    theta = [0.57, 0.19, 0.19, 0.05]
    src, dst = tr.rmat(0, theta, 10, 8, 5_000, res=CPU)
    assert int(src.min()) >= 0 and int(src.max()) < 2 ** 10
    assert int(dst.min()) >= 0 and int(dst.max()) < 2 ** 8
    s2, _ = tr.rmat(0, theta, 10, 8, 5_000, res=CPU)
    assert torch.equal(src, s2)
    src, _ = tr.rmat(1, [0.9, 0.03, 0.03, 0.04], 12, 12, 4_000, res=CPU)
    assert np.median(src.numpy()) < 2 ** 12 / 8
    assert tr.rmat is tr.rmat_rectangular_gen
    with pytest.raises(RaftError, match=r"scales must be in \[1, 31\]"):
        tr.rmat(0, theta, 32, 4, 10, res=CPU)
    with pytest.raises(RaftError, match="flat theta must have 4 entries"):
        tr.rmat(0, [0.5, 0.5], 4, 4, 10, res=CPU)
    with pytest.raises(RaftError, match=r"theta must be \(max_scale, 4\)"):
        tr.rmat(0, np.ones((3, 4)), 4, 4, 10, res=CPU)
