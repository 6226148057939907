"""Single-linkage hierarchical agglomerative clustering.

Counterpart of raft_tpu/cluster/single_linkage.py (reference: raft/cluster/
single_linkage.cuh :85): connectivities (the full pairwise graph, or a kNN
graph through the port's ``brute_force.knn``, which runs the ``fused_knn``
kernel on a card) -> Borůvka MST, repaired into a tree by
``connect_components`` rounds -> the dendrogram and its cut. The graph and
the MST run on the device; the dendrogram is a strictly sequential
union-find over the sorted MST edges and runs on the host in numpy, as in
the JAX package (and the reference, whose serial merge also runs on host
memory).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..distance.types import DistanceType, resolve_metric
from ..solver.mst import _mst
from ..sparse.convert import sort_coo
from ..sparse.neighbors import connect_components
from ..sparse.op import max_duplicates
from ..sparse.types import CooMatrix

__all__ = ["SingleLinkageOutput", "single_linkage", "build_dendrogram_host", "cut_tree_host"]

_i32 = torch.int32
REPAIR_ROUNDS = 32
_L2 = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded, DistanceType.L2Unexpanded,
       DistanceType.L2SqrtUnexpanded)
_SQRT = (DistanceType.L2SqrtExpanded, DistanceType.L2SqrtUnexpanded)


@dataclasses.dataclass
class SingleLinkageOutput:
    """Reference: linkage_output (cluster/single_linkage_types.hpp)."""

    labels: torch.Tensor      # (n,) int32
    children: np.ndarray      # (n-1, 2) merge tree (scipy linkage convention)
    deltas: np.ndarray        # (n-1,) merge distances
    sizes: np.ndarray         # (n-1,) merged cluster sizes
    n_clusters: int


def build_dendrogram_host(src, dst, weights, n: int):
    """Sequential union-find dendrogram from sorted MST edges (reference:
    cluster/detail/agglomerative.cuh build_dendrogram_host). Returns
    (children (n-1, 2), deltas, sizes) in scipy's convention (new cluster
    ids n, n+1, ...)."""
    parent = np.arange(2 * n - 1, dtype=np.int64)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    children = np.zeros((n - 1, 2), np.int64)
    deltas = np.zeros((n - 1,), np.float64)
    sizes = np.zeros((n - 1,), np.int64)
    csize = np.ones(2 * n - 1, np.int64)
    nxt = n
    m = 0
    for e in range(len(src)):
        a, b = int(src[e]), int(dst[e])
        if a >= n or b >= n:
            continue
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        children[m] = (min(ra, rb), max(ra, rb))
        deltas[m] = float(weights[e])
        sizes[m] = csize[ra] + csize[rb]
        parent[ra] = parent[rb] = nxt
        csize[nxt] = sizes[m]
        nxt += 1
        m += 1
        if m == n - 1:
            break
    return children[:m], deltas[:m], sizes[:m]


def cut_tree_host(children, n: int, n_clusters: int):
    """Flatten the dendrogram at ``n_clusters`` (reference:
    cluster/detail/agglomerative.cuh extract_flattened_clusters)."""
    n_merges = max(n - n_clusters, 0)
    parent = np.arange(2 * n - 1, dtype=np.int64)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for m in range(min(n_merges, len(children))):
        a, b = children[m]
        nxt = n + m
        parent[find(a)] = nxt
        parent[find(b)] = nxt
    roots = {}
    labels = np.zeros(n, np.int32)
    for i in range(n):
        r = find(i)
        if r not in roots:
            roots[r] = len(roots)
        labels[i] = roots[r]
    return labels


def _pack(rows, cols, vals, nnz, n: int) -> CooMatrix:
    """Edges canonicalised to (min, max) (``mst`` keeps row < col) and
    deduplicated by max, which keeps a reciprocal pair at its weight."""
    valid = rows < n
    lo = torch.where(valid, torch.minimum(rows, cols), n)
    hi = torch.where(valid, torch.maximum(rows, cols), n)
    vals = torch.where(valid & torch.isfinite(vals), vals, torch.zeros_like(vals))
    return max_duplicates(sort_coo(CooMatrix(lo, hi, vals, nnz, (n, n))))


def _connectivities(x, mt: DistanceType, connectivity: str, n_neighbors: int,
                    res: Resources) -> CooMatrix:
    """The graph single linkage runs its MST over."""
    n = x.shape[0]
    dev = x.device
    if connectivity == "pairwise":
        from ..distance.pairwise import pairwise_distance

        d = pairwise_distance.native(x, x, metric=mt, res=res)
        iu, ju = torch.triu_indices(n, n, offset=1, device=dev)
        return CooMatrix(iu.to(_i32), ju.to(_i32), d[iu, ju],
                         torch.tensor(iu.shape[0], dtype=_i32, device=dev), (n, n))
    expects(connectivity == "knn", "connectivity must be 'pairwise' or 'knn'")
    expects(mt in _L2, "knn connectivity requires an L2 metric (reference parity: "
            "cluster/detail/connectivities.cuh knn path is L2-only), got %s", mt.name)
    from ..neighbors.brute_force import knn as dense_knn

    k = min(n_neighbors, n - 1)
    dists, idx = dense_knn.native(x, x, k + 1, metric=mt, res=res)
    rows = torch.arange(n, dtype=_i32, device=dev).repeat_interleave(k + 1)
    cols = idx.reshape(-1).to(_i32)
    keep = rows != cols
    return _pack(torch.where(keep, rows, n), torch.where(keep, cols, n),
                 torch.where(keep, dists.reshape(-1).to(torch.float32), 0.0),
                 keep.sum().to(_i32), n)


def _repair(x, out, mt: DistanceType, res: Resources):
    """Forest -> tree: up to :data:`REPAIR_ROUNDS` rounds of
    ``connect_components`` edges merged into the MST and solved again
    (reference: cluster/detail/mst.cuh build_sorted_mst). Returns (MST, the
    graph it was solved over or None, rounds)."""
    n = x.shape[0]
    graph = None
    rounds = 0
    for rounds in range(REPAIR_ROUNDS + 1):
        if rounds == REPAIR_ROUNDS or int(out.n_edges) >= n - 1:
            break
        extra = connect_components(x, out.colors, res=res)
        # connect_components' weights are squared L2: match the graph's units
        vals = extra.vals
        if mt in _SQRT:
            vals = torch.sqrt(torch.clamp_min(vals, 0.0))
        graph = _pack(torch.cat([out.src, extra.rows]), torch.cat([out.dst, extra.cols]),
                      torch.cat([out.weights, vals]), out.n_edges + extra.nnz, n)
        out = _mst(graph)[0]
    return out, graph, rounds


def single_linkage(x, n_clusters: int, connectivity: str = "knn", n_neighbors: int = 15,
                   metric: str = "sqeuclidean",
                   res: Resources | None = None) -> SingleLinkageOutput:
    """Single-linkage clustering of dense points on the handle's device
    (reference: raft::cluster::single_linkage, cluster/single_linkage.cuh:85).

    ``connectivity``: "pairwise" (the complete graph: exact) or "knn" (an
    ``n_neighbors`` graph repaired across components, the reference's
    KNN_GRAPH path; with few neighbours the graph can be connected yet miss
    true MST edges, so merge heights can deviate from exact single linkage).
    """
    res = res or default_resources()
    x = res.put(x)
    expects(x.ndim == 2, "x must be (n, d)")
    n = x.shape[0]
    expects(1 <= n_clusters <= n, "n_clusters must be in [1, n]")
    mt = resolve_metric(metric)
    out = _mst(_connectivities(x, mt, connectivity, n_neighbors, res))[0]
    out = _repair(x, out, mt, res)[0]
    ne = int(out.n_edges)
    children, deltas, sizes = build_dendrogram_host(
        out.src[:ne].cpu().numpy(), out.dst[:ne].cpu().numpy(),
        out.weights[:ne].cpu().numpy(), n)
    labels = cut_tree_host(children, n, n_clusters)
    return SingleLinkageOutput(labels=torch.from_numpy(labels).to(x.device), children=children,
                               deltas=deltas, sizes=sizes, n_clusters=n_clusters)
