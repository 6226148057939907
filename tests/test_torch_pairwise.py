"""raft_tpu_torch.distance.pairwise against raft_tpu.distance.pairwise, every
metric, on seeded numpy inputs (CPU, rtol=1e-5, 1e-4 for KL divergence and
Jensen-Shannon: the products and sums run in different orders); and
brute-force kNN under each metric against the JAX package's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.distance import pairwise as jpw
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.distance import pairwise as tpw
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.neighbors import brute_force as tbf
from test_fused_knn import assert_knn_equiv

CPU = Resources(device="cpu")


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product",
                                    "cosine", DistanceType.L2Expanded,
                                    DistanceType.L2SqrtExpanded])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_matches_jax(metric, compute):
    rng = np.random.default_rng(31)
    x = rng.random((37, 20), np.float32)
    y = rng.random((53, 20), np.float32)
    if compute == "bfloat16":
        # the JAX package's bfloat16 mode is a TPU precision hint (full
        # float32 on the CPU); give both bf16-exact operands to compare
        x, y = (np.asarray(torch.from_numpy(a).bfloat16().float()) for a in (x, y))
    jm = metric if isinstance(metric, str) else jpw.DistanceType(int(metric))
    ref = np.asarray(jpw.pairwise_distance(jnp.asarray(x), jnp.asarray(y), jm,
                                           compute=compute))
    got = tpw.pairwise_distance(x, y, metric, compute=compute, res=CPU).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)


def test_tiling_helpers_match_jax():
    for m, n, d, b in ((10_000, 1_000_000, 1, 2 << 30), (37, 53, 20, 4096),
                       (5, 10, 3, 1 << 40)):
        assert tpw._choose_tile(m, n, d, b) == jpw._choose_tile(m, n, d, b)
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    jt, jn = jpw._pad_to_tiles(jnp.asarray(x), 4)
    tt, tn = tpw._pad_to_tiles(torch.from_numpy(x), 4)
    assert jn == tn and np.array_equal(np.asarray(jt), tt.numpy())


def test_unported_metric_raises():
    """Every metric is ported; Precomputed has no formula and raises, as do
    haversine inputs that are not (lat, lon) pairs."""
    with pytest.raises(RaftError, match="no pairwise formula"):
        tpw.pairwise_distance(np.ones((2, 3)), metric=DistanceType.Precomputed, res=CPU)
    with pytest.raises(RaftError, match="d == 2"):
        tpw.pairwise_distance(np.ones((2, 3)), metric="haversine", res=CPU)


# the metrics of this file's first test aside, by name; (metric_arg,
# inputs, rtol)
NEW_METRICS = {
    "correlation": (2.0, "signed", 1e-5),
    "hellinger": (2.0, "simplex", 1e-5),
    "russellrao": (2.0, "binary", 1e-5),
    "kl_divergence": (2.0, "simplex", 1e-4),
    "jaccard": (2.0, "binary", 1e-5),
    "dice": (2.0, "binary", 1e-5),
    "l1": (2.0, "signed", 1e-5),
    "chebyshev": (2.0, "signed", 1e-5),
    "canberra": (2.0, "signed", 1e-5),
    "minkowski": (3.0, "signed", 1e-5),
    "braycurtis": (2.0, "signed", 1e-5),
    "jensenshannon": (2.0, "simplex", 1e-4),
    "hamming": (2.0, "binary", 1e-5),
    "haversine": (2.0, "latlon", 1e-5),
}


def _inputs(kind, m, n, d, seed):
    """x (m, d), y (n, d) with zero rows, zero entries and, where the metric
    takes them, negative entries; binary kinds are 0/1 with an all-zero row
    in each (so 0/0 guards fire); simplex rows sum to 1 with zeros; latlon
    is (lat, lon) radians."""
    rng = np.random.default_rng(seed)
    if kind == "latlon":
        def pts(r):
            return np.stack([rng.uniform(-np.pi / 2, np.pi / 2, r),
                             rng.uniform(-np.pi, np.pi, r)], 1).astype(np.float32)
        x, y = pts(m), pts(n)
        y[3] = x[0]                                  # a zero distance
        return x, y
    if kind == "binary":
        x = (rng.random((m, d)) < 0.3).astype(np.float32)
        y = (rng.random((n, d)) < 0.3).astype(np.float32)
    else:
        x = rng.uniform(-1, 1, (m, d)).astype(np.float32)
        y = rng.uniform(-1, 1, (n, d)).astype(np.float32)
        x[rng.random((m, d)) < 0.2] = 0.0
        y[rng.random((n, d)) < 0.2] = 0.0
        if kind == "simplex":
            x, y = np.abs(x), np.abs(y)
    x[1] = 0.0
    y[2] = 0.0
    y[4] = x[5]                                      # an identical pair
    if kind == "simplex":
        x[1, 0] = y[2, 0] = 1.0
        x /= x.sum(1, keepdims=True)
        y /= y.sum(1, keepdims=True)
    return x, y


@pytest.mark.parametrize("metric", sorted(NEW_METRICS))
def test_every_metric_matches_jax(metric):
    arg, kind, rtol = NEW_METRICS[metric]
    d = 2 if kind == "latlon" else 24
    x, y = _inputs(kind, 31, 45, d, seed=len(metric))
    ref = np.asarray(jpw.pairwise_distance(jnp.asarray(x), jnp.asarray(y), metric,
                                           metric_arg=arg))
    got = tpw.pairwise_distance(x, y, metric, metric_arg=arg, res=CPU)
    assert got.dtype == torch.float32 and got.shape == (31, 45)
    got = got.numpy()
    if metric == "hellinger":
        # sqrt(1 - Σ√(xy)) of an identical pair is the root of rounding
        # noise (~1e-4 either side): near 0 the squares are compared
        np.testing.assert_allclose(got ** 2, ref ** 2, rtol=rtol, atol=1e-6)
        near0 = ref < 1e-2
        got, ref = got[~near0], ref[~near0]
    # NaN where the reference gives NaN (cosine-type metrics of a zero row)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("metric", ["l1", "chebyshev", "jensenshannon"])
def test_elementwise_tiles_match_one_tile(metric):
    """A workspace that forces 8-row tiles answers as one tile does."""
    _, kind, _ = NEW_METRICS[metric]
    x, y = _inputs(kind, 29, 40, 16, seed=3)
    small = Resources(device="cpu", workspace_bytes=8 * 40 * 18 * 4)
    assert tpw._choose_tile(29, 40, 16, small.workspace_bytes) == 8
    np.testing.assert_array_equal(
        tpw.pairwise_distance(x, y, metric, res=small).numpy(),
        tpw.pairwise_distance(x, y, metric, res=CPU).numpy())


@pytest.mark.parametrize("metric", sorted(NEW_METRICS))
def test_knn_every_metric_matches_jax(metric):
    """brute_force.knn under each metric (the GEMM + top-k route on both
    sides): ids equal except where distances tie within the tolerance."""
    arg, kind, rtol = NEW_METRICS[metric]
    d = 2 if kind == "latlon" else 24
    x, q = _inputs(kind, 19, 300, d, seed=7 + len(metric))
    x, q = q, x                                        # 300 dataset rows
    # query 5 equals dataset row 4: its hellinger distance is the root of
    # float32 rounding noise, sqrt(24 * 2^-24) ~ 1.2e-3 at most
    atol = 2e-3 if metric == "hellinger" else 1e-5
    for k in (1, 10):
        jd, ji = jbf.knn(jnp.asarray(x), jnp.asarray(q), k, metric=metric, metric_arg=arg)
        td, ti = tbf.knn(x, q, k, metric=metric, metric_arg=arg, res=CPU)
        assert ti.dtype == torch.int32
        assert_knn_equiv(td.numpy(), ti.numpy(), np.asarray(jd), np.asarray(ji),
                         rtol=rtol, atol=atol)
