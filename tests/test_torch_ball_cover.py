"""raft_tpu_torch.neighbors.ball_cover against raft_tpu.neighbors.ball_cover.

Landmarks come from different random streams, so the port's index is built
around the JAX index's landmark rows (``from_state``); the ball cover is
exact, so both give the exact neighbour sets, held as
tests/test_ball_cover.py holds the JAX package: sorted distances within
1e-4 (for euclidean, their squares), ids equal except where distances
tie. The port's own build is held to the exact answer too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.neighbors import ball_cover as jbc
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.neighbors import ball_cover as tbc

CPU = Resources(device="cpu")


def _dists(x, q, metric):
    """(m, n) float64 distances in the metric."""
    if metric == "haversine":
        lat1, lon1 = q[:, None, 0], q[:, None, 1]
        lat2, lon2 = x[None, :, 0], x[None, :, 1]
        h = (np.sin(0.5 * (lat2 - lat1)) ** 2
             + np.cos(lat1) * np.cos(lat2) * np.sin(0.5 * (lon2 - lon1)) ** 2)
        return 2.0 * np.arcsin(np.sqrt(np.clip(h, 0.0, 1.0)))
    d = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    return np.sqrt(d) if metric == "euclidean" else d


def _assert_exact(td, ti, x, q, k, metric, tol=1e-4):
    """Sorted distances within ``tol`` of the exact k nearest; ids equal
    except where the k-th distance ties (every id in either set but not
    both lies within ``tol`` of it)."""
    td, ti = np.asarray(td), np.asarray(ti)
    d = _dists(x, q, metric)
    ri = np.argsort(d, axis=1, kind="stable")[:, :k]
    rd = np.take_along_axis(d, ri, 1)
    if metric == "euclidean":
        # the expanded form's cancellation error lies in the squared domain
        np.testing.assert_allclose(np.sort(td, 1) ** 2, rd ** 2, rtol=tol, atol=tol)
    else:
        np.testing.assert_allclose(np.sort(td, 1), rd, rtol=tol, atol=tol)
    for r in range(len(q)):
        for i in set(ti[r].tolist()) ^ set(ri[r].tolist()):
            assert abs(d[r, i] - rd[r, -1]) <= tol * max(1.0, rd[r, -1]), (r, i)


SETS = {
    "sqeuclidean": lambda rng: rng.random((1200, 3)).astype(np.float32),
    "euclidean": lambda rng: rng.random((1200, 5)).astype(np.float32),
    "haversine": lambda rng: np.stack([rng.uniform(-1.4, 1.4, 1200),
                                       rng.uniform(-3.1, 3.1, 1200)], 1).astype(np.float32),
}


@pytest.fixture(scope="module", params=list(SETS))
def case(request):
    metric = request.param
    rng = np.random.default_rng(9)
    x = SETS[metric](rng)
    q = x[rng.choice(len(x), 40, replace=False)] + 0.01 * rng.normal(size=(40, x.shape[1]))
    q = q.astype(np.float32)
    jindex = jbc.build(jnp.asarray(x), metric=metric, seed=0)
    tindex = tbc.from_state(x, np.asarray(jindex.landmarks), metric=metric, res=CPU)
    # the JAX package's answers, one call each (every new shape costs a trace)
    eps = 0.05 if metric != "haversine" else 0.1
    jax_out = {"knn": jbc.knn_query(jindex, jnp.asarray(q), 10),
               "all_knn": jbc.all_knn_query(jindex, 5),
               "eps": (eps, *jbc.eps_nn_query(jindex, jnp.asarray(q), eps))}
    return metric, x, q, jindex, tindex, jax_out


def test_index_matches_jax(case):
    _, _, _, jindex, tindex, _ = case
    assert tindex.capacity == jindex.capacity
    np.testing.assert_array_equal(tindex.list_ids.numpy(), np.asarray(jindex.list_ids))
    np.testing.assert_array_equal(tindex.list_data.numpy(), np.asarray(jindex.list_data))
    np.testing.assert_allclose(tindex.radii.numpy(), np.asarray(jindex.radii), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("k", [1, 10, 50])
def test_knn_query_matches_jax_and_exact(case, k):
    metric, x, q, _, tindex, jax_out = case
    td, ti = tbc.knn_query(tindex, q, k, res=CPU)
    assert td.dtype == torch.float32 and ti.dtype == torch.int32
    _assert_exact(td, ti, x, q, k, metric)
    if k == 10:
        _assert_exact(*jax_out["knn"], x, q, k, metric)


def test_port_build_is_exact(case):
    metric, x, q, _, _, _ = case
    index = tbc.build(x, metric=metric, seed=3, res=CPU)
    assert index.n_landmarks == int(np.sqrt(len(x)))
    td, ti = tbc.knn_query(index, q, 10, res=CPU)
    _assert_exact(td, ti, x, q, 10, metric)


def test_all_knn_query_matches_jax(case):
    metric, x, _, _, tindex, jax_out = case
    td, ti = tbc.all_knn_query(tindex, 5, res=CPU)
    _assert_exact(td, ti, x, x, 5, metric)
    _assert_exact(*jax_out["all_knn"], x, x, 5, metric)


def test_eps_nn_query_matches_jax(case):
    _, _, q, _, tindex, jax_out = case
    eps, ja, jdeg = jax_out["eps"]
    ta, tdeg = tbc.eps_nn_query(tindex, q, eps, res=CPU)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tdeg.numpy(), np.asarray(jdeg))
    assert int(tdeg[-1]) > 0


def test_contract_errors():
    x = np.random.default_rng(0).random((100, 3)).astype(np.float32)
    with pytest.raises(RaftError, match="L2 / haversine"):
        tbc.build(x, metric="inner_product", res=CPU)
    with pytest.raises(RaftError, match="haversine requires"):
        tbc.build(x, metric="haversine", res=CPU)
    index = tbc.build(x, res=CPU)
    with pytest.raises(RaftError, match="query dim"):
        tbc.knn_query(index, x[:, :2], 3, res=CPU)
