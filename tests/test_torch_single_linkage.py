"""raft_tpu_torch.cluster.single_linkage against raft_tpu's on the same
points (CPU), on both connectivity routes.

Tolerances: deltas against JAX's rtol 1e-5 (the graphs' distances come
from GEMMs that round differently; on the knn route, where both packages
score the expanded form ‖x‖² + ‖y‖² − 2·x·y, within its float32 bound
where that is larger); partitions equal up to the labels'
names; ``children`` equal where no two MST weights tie; the host
dendrogram and cut equal on the same edges. The JAX file's cases
(tests/test_solver.py's single-linkage and connect_components tests) run
against scipy on the port.
"""

import numpy as np
import pytest
from scipy.cluster.hierarchy import fcluster, linkage

import jax.numpy as jnp

from raft_tpu.cluster import single_linkage as jsl
from raft_tpu.cluster.single_linkage import build_dendrogram_host as j_dendro
from raft_tpu.cluster.single_linkage import cut_tree_host as j_cut
from raft_tpu_torch.cluster import single_linkage as tsl
from raft_tpu_torch.cluster.single_linkage import (REPAIR_ROUNDS, _connectivities, _repair,
                                                   build_dendrogram_host, cut_tree_host)
from raft_tpu_torch.core import RaftError, Resources
from raft_tpu_torch.distance.types import resolve_metric
from raft_tpu_torch.solver.mst import _mst

CPU = Resources(device="cpu")


def _same_partition(a, b):
    a, b = np.asarray(a), np.asarray(b)
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def _no_ties(deltas):
    s = np.sort(deltas)
    return bool((np.diff(s) > 0).all())


# one shape, so the JAX programs of a route and metric are shared
CASES = [("pairwise", "euclidean", 1), ("pairwise", "sqeuclidean", 2),
         ("knn", "sqeuclidean", 3), ("knn", "euclidean", 4), ("knn", "sqeuclidean", 5)]


@pytest.mark.parametrize("connectivity,metric,seed", CASES)
def test_matches_jax(connectivity, metric, seed):
    n, d = 48, 4
    x = np.random.default_rng(seed).random((n, d)).astype(np.float32)
    jo = jsl(jnp.asarray(x), n_clusters=5, connectivity=connectivity, metric=metric,
             n_neighbors=4)
    to = tsl(x, n_clusters=5, connectivity=connectivity, metric=metric, n_neighbors=4, res=CPU)
    assert to.deltas.shape == (n - 1,) and to.n_clusters == 5
    atol = 0.0
    if connectivity == "knn":
        # the knn route's distances are the expanded form's on both sides:
        # rtol 1e-5, or the float32 form's bound d·2⁻²⁴·4·max‖x‖² (its
        # root for euclidean), whichever is larger
        atol = d * 2.0 ** -24 * 4 * float((x.astype(np.float64) ** 2).sum(1).max())
        atol = np.sqrt(atol) if metric == "euclidean" else atol
    np.testing.assert_allclose(to.deltas, jo.deltas, rtol=1e-5, atol=atol)
    np.testing.assert_array_equal(to.sizes, jo.sizes)
    assert _same_partition(to.labels.numpy(), np.asarray(jo.labels))
    if _no_ties(jo.deltas):
        np.testing.assert_array_equal(to.children, jo.children)
    assert int(to.sizes[-1]) == n


def test_dendrogram_and_cut_match_jax():
    """The host steps on the same sorted edges, ties included."""
    rng = np.random.default_rng(3)
    n = 30
    src = rng.permutation(n - 1)
    dst = src + 1
    w = np.round(rng.random(n - 1), 1).astype(np.float32)     # many ties
    order = np.argsort(w, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    jc, jd, js = j_dendro(src, dst, w, n)
    tc, td, ts = build_dendrogram_host(src, dst, w, n)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ts, js)
    for k in (1, 4, n):
        np.testing.assert_array_equal(cut_tree_host(tc, n, k), j_cut(jc, n, k))


@pytest.mark.parametrize("connectivity", ["pairwise", "knn"])
def test_recovers_blobs_as_scipy(connectivity):
    rng = np.random.default_rng(4)
    centers = np.array([[0, 0], [10, 0], [0, 10]], np.float32)
    x = np.concatenate([rng.normal(c, 0.3, (20, 2)).astype(np.float32) for c in centers])
    out = tsl(x, n_clusters=3, connectivity=connectivity, n_neighbors=5, res=CPU)
    expect = fcluster(linkage(x, method="single"), 3, criterion="maxclust")
    assert _same_partition(out.labels.numpy(), expect)


@pytest.mark.parametrize("connectivity,n_neighbors", [("pairwise", 15), ("knn", 15)])
def test_deltas_match_scipy(connectivity, n_neighbors):
    x = np.random.default_rng(5).random((40, 3)).astype(np.float32)
    out = tsl(x, n_clusters=1, connectivity=connectivity, n_neighbors=n_neighbors,
              metric="euclidean", res=CPU)
    expect = linkage(x, method="single", metric="euclidean")
    np.testing.assert_allclose(np.sort(out.deltas), np.sort(expect[:, 2]), rtol=1e-4)


def test_knn_repairs_a_disconnected_graph_as_jax():
    """Far blobs and 3 neighbours: the kNN graph splits, the repair rounds
    join it; the port's MST over its repaired graph equals JAX's edges."""
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.normal(0, 0.05, (15, 2)), rng.normal(100, 0.05, (15, 2)),
                        rng.normal(-100, 0.05, (15, 2))]).astype(np.float32)
    jo = jsl(jnp.asarray(x), n_clusters=3, connectivity="knn", n_neighbors=3)
    to = tsl(x, n_clusters=3, connectivity="knn", n_neighbors=3, res=CPU)
    labels = to.labels.numpy()
    assert len(np.unique(labels)) == 3 and _same_partition(labels, np.asarray(jo.labels))
    # the blobs sit ~100 from the origin with a spread of 0.05: their inner
    # squared distances (~0.005) are below the float32 expanded form's
    # rounding, d·2⁻²⁴·4·max‖x‖² (~0.01), so those deltas are held to that
    # bound; the two joins across blobs (~10⁴) to rtol 1e-5
    bound = x.shape[1] * 2.0 ** -24 * 4 * float((x.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(to.deltas[:-2], jo.deltas[:-2], rtol=0, atol=bound)
    np.testing.assert_allclose(to.deltas[-2:], jo.deltas[-2:], rtol=1e-5)
    # the steps: a forest first, then a tree within the round limit
    mt = resolve_metric("sqeuclidean")
    xt = CPU.put(x)
    out = _mst(_connectivities(xt, mt, "knn", 3, CPU))[0]
    assert int(out.n_edges) < len(x) - 1
    fixed, graph, rounds = _repair(xt, out, mt, CPU)
    assert int(fixed.n_edges) == len(x) - 1 and 1 <= rounds <= REPAIR_ROUNDS
    assert graph is not None


def test_checks():
    x = np.random.default_rng(7).random((10, 2)).astype(np.float32)
    with pytest.raises(RaftError, match="L2"):
        tsl(x, n_clusters=2, connectivity="knn", metric="l1", res=CPU)
    with pytest.raises(RaftError, match="connectivity"):
        tsl(x, n_clusters=2, connectivity="full", res=CPU)
    with pytest.raises(RaftError, match="n_clusters"):
        tsl(x, n_clusters=11, res=CPU)
