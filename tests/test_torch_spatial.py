"""raft_tpu_torch.spatial (the legacy spatial::knn surface) against
raft_tpu.spatial on the CPU: the approximate-kNN dispatch over IVF-Flat and
IVF-PQ params and indexes, and haversine kNN (distances rtol 1e-5, ids
equal except within-tolerance ties)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import spatial as jsp
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu_torch import spatial as tsp
from raft_tpu_torch.core import Resources
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from test_fused_knn import assert_knn_equiv

CPU = Resources(device="cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    centers = rng.uniform(-4, 4, (30, 16))
    x = (centers[rng.integers(0, 30, 2000)] + rng.normal(0, 1, (2000, 16))).astype(np.float32)
    q = (centers[rng.integers(0, 30, 50)] + rng.normal(0, 1, (50, 16))).astype(np.float32)
    return x, q


def test_approx_knn_over_ivf_flat_matches_jax(data, tmp_path):
    x, q = data
    jindex = jsp.approx_knn_build_index(jfl.IndexParams(n_lists=16), jnp.asarray(x),
                                        metric="euclidean")
    path = str(tmp_path / "flat.bin")
    jfl.save(jindex, path)
    tindex = tfl.load(path, res=CPU)
    jd, ji = jsp.approx_knn_search(jindex, jnp.asarray(q), 10, n_probes=4)
    td, ti = tsp.approx_knn_search(tindex, q, 10, n_probes=4, res=CPU)
    assert_knn_equiv(td.numpy(), ti.numpy(), np.asarray(jd), np.asarray(ji), rtol=1e-5,
                     atol=1e-5)
    own = tsp.approx_knn_build_index(tfl.IndexParams(n_lists=16), x, metric="euclidean",
                                     res=CPU)
    assert isinstance(own, tfl.IvfFlatIndex) and own.metric == jindex.metric


def test_approx_knn_dispatch_over_both_kinds(data):
    x, q = data
    for mod, params in ((tfl, tfl.IndexParams(n_lists=16)),
                        (tpq, tpq.IndexParams(n_lists=16, pq_dim=8))):
        index = tsp.approx_knn_build_index(params, x, metric="sqeuclidean", res=CPU)
        d, i = tsp.approx_knn_search(index, q, 7, n_probes=5, res=CPU)
        rd, ri = mod.search(mod.SearchParams(n_probes=5), index, q, 7, res=CPU)
        assert torch.equal(i, ri) and torch.equal(d, rd)
    with pytest.raises(TypeError, match="legacy ANN params"):
        tsp.approx_knn_build_index(object(), x, res=CPU)
    with pytest.raises(TypeError, match="legacy ANN index"):
        tsp.approx_knn_search(object(), q, 3)


def test_haversine_knn_matches_jax():
    rng = np.random.default_rng(5)

    def pts(n):
        return np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-3.1, 3.1, n)],
                        1).astype(np.float32)

    x, q = pts(800), pts(40)
    jd, ji = jsp.haversine_knn(jnp.asarray(x), jnp.asarray(q), 8)
    td, ti = tsp.haversine_knn(x, q, 8, res=CPU)
    assert_knn_equiv(td.numpy(), ti.numpy(), np.asarray(jd), np.asarray(ji), rtol=1e-5,
                     atol=1e-6)
    assert tsp.knn is tbf.knn and tsp.brute_force_knn is tbf.knn
