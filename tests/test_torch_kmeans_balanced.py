"""raft_tpu_torch.cluster.kmeans_balanced against
raft_tpu.cluster.kmeans_balanced.

The two packages draw different random numbers from one seed, so a fit is
judged by quality: on the same seeded data the port's inertia is within 5%
of the JAX fit's and its clusters are as balanced. Assignment against given
centers is deterministic and is compared row by row.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.cluster import kmeans_balanced as jkb
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.cluster import kmeans_balanced as tkb

CPU = Resources(device="cpu")
N, D, K = 4000, 32, 32


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(5)
    # overlapping blobs: well-separated ones would make the comparison one of
    # which local minimum each random start falls into
    centers = rng.normal(size=(200, D)).astype(np.float32)
    labels = rng.integers(0, 200, N)
    return (centers[labels] + 0.7 * rng.normal(size=(N, D))).astype(np.float32)


def _inertia(x, centers):
    d2 = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
    labels = d2.argmin(1)
    return d2.min(1).sum(), np.bincount(labels, minlength=centers.shape[0])


@pytest.mark.parametrize("mode", ["full", "minibatch"])
def test_fit_quality_matches_jax(blobs, mode):
    """Per seed, inertia within 5% of the JAX fit's; over three seeds, list
    sizes as balanced (mean spread and mean largest list within 20%)."""
    spread, largest = [], []
    for seed in (0, 1, 2):
        params = dict(n_iters=20, seed=seed, train_mode=mode, batch_rows=1000)
        jc = np.asarray(jkb.fit(jkb.KMeansBalancedParams(**params), jnp.asarray(blobs), K))
        tc = tkb.fit(tkb.KMeansBalancedParams(**params), blobs, K, res=CPU)
        assert tc.shape == (K, D) and tc.dtype == torch.float32
        j_in, j_sizes = _inertia(blobs, jc)
        t_in, t_sizes = _inertia(blobs, tc.numpy())
        assert t_in <= 1.05 * j_in, (seed, t_in, j_in)
        assert t_sizes.min() > 0        # the balancing step leaves no list empty
        spread.append((t_sizes.std(), j_sizes.std()))
        largest.append((t_sizes.max(), j_sizes.max()))
    (t_sd, j_sd), (t_max, j_max) = np.mean(spread, 0), np.mean(largest, 0)
    assert t_sd <= 1.2 * j_sd and t_max <= 1.2 * j_max, (spread, largest)


def test_trainset_cap_and_inner_product(blobs):
    params = dict(n_iters=10, seed=3, max_train_points=1500, metric="inner_product")
    jc = np.asarray(jkb.fit(jkb.KMeansBalancedParams(**params), jnp.asarray(blobs), 16))
    tc = tkb.fit(tkb.KMeansBalancedParams(**params), blobs, 16, res=CPU).numpy()

    def spread(c):     # IP clusters: the sum of best scores (higher = better)
        return (blobs @ c.T).max(1).sum()

    assert spread(tc) >= spread(jc) - 0.05 * abs(spread(jc)), (spread(tc), spread(jc))


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_predict_matches_jax(blobs, metric):
    rng = np.random.default_rng(1)
    centers = blobs[rng.choice(N, K, replace=False)] + 0.01
    jl = np.asarray(jkb.predict(jnp.asarray(blobs), jnp.asarray(centers), metric=metric))
    tl = tkb.predict(blobs, centers, metric=metric, res=CPU)
    assert tl.dtype == torch.int32
    # the two sum the products in different orders: a near tie may flip
    assert np.mean(tl.numpy() != jl) <= 1e-3


def test_build_clusters_and_train_mode(blobs):
    c, labels, sizes = tkb.build_clusters(tkb.KMeansBalancedParams(n_iters=5), blobs, K,
                                          res=CPU)
    assert int(sizes.sum()) == N and sizes.dtype == torch.int32
    assert torch.equal(torch.bincount(labels.long(), minlength=K).int(), sizes)
    for mode, n, b in (("auto", 200_000, 65536), ("auto", 100_000, 65536),
                       ("full", 10**6, 10), ("minibatch", 10, 10)):
        assert tkb.resolve_train_mode(mode, n, b) == jkb.resolve_train_mode(mode, n, b)
    with pytest.raises(RaftError, match="train_mode"):
        tkb.resolve_train_mode("fast", 10, 10)
    with pytest.raises(RaftError, match="L2 / inner_product"):
        tkb.fit(tkb.KMeansBalancedParams(metric="l1"), blobs, K, res=CPU)
