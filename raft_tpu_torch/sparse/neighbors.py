"""Sparse brute-force kNN, the kNN graph, and the cross-component repair.

Counterpart of raft_tpu/sparse/neighbors.py (reference: raft/sparse/
neighbors/knn.cuh, knn_graph.cuh, detail/connect_components.cuh). Queries
are scored in row tiles by the sparse distance staging (sparse/distance.py)
and each tile's (tile, n) block goes through ``select_k_impl``: on a card a
row of ``wide_cols_threshold()`` columns or more runs the ``topk`` kernel,
where the JAX package runs ``lax.top_k`` (the answers are equal).

Unlike the JAX module, ``knn`` scores the unexpanded L2 metrics by their
expanded GEMM form, as both packages' dense brute force does (the kNN
order is the same; distances differ by rounding): the elementwise form
broadcasts (tile, n, d) over every dimension, which at a TF-IDF width of
8,192 leaves tiles of 8 rows and a 26 GB block each at 100,000 rows.
"""

from __future__ import annotations

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..distance import pairwise as _pw
from ..distance.types import DistanceType
from ..matrix.select_k import select_k_impl
from .distance import (_checked, _dense_block, _densify, _tile_for, csr_to_ell, ell_tiles,
                       on_device_of)
from .types import CooMatrix, CsrMatrix

__all__ = ["knn", "knn_graph", "connect_components"]

_f32 = torch.float32
_i32 = torch.int32
_BIG = 2**31 - 1
# kNN order is the same under expanded and unexpanded L2
_EXPANDED_L2 = {DistanceType.L2Unexpanded: DistanceType.L2Expanded,
                DistanceType.L2SqrtUnexpanded: DistanceType.L2SqrtExpanded}


def _cross_component_nn(x, colors, tile: int):
    """Each point's nearest neighbour in another component (squared L2),
    over row tiles: (dist (n,), idx (n,) int32). Ties go to the lowest id."""
    xf = x.to(_f32)
    norms = (xf * xf).sum(dim=1)
    dist, idx = [], []
    with _pw.full_f32():
        for i in range(0, x.shape[0], tile):
            xb = xf[i:i + tile]
            d2 = norms[i:i + tile, None] + norms[None, :] - 2.0 * (xb @ xf.T)
            d2 = torch.where(colors[i:i + tile, None] == colors[None, :], torch.inf,
                             torch.clamp_min(d2, 0.0))
            j = torch.argmin(d2, dim=1)
            dist.append(torch.gather(d2, 1, j[:, None])[:, 0])
            idx.append(j.to(_i32))
    return torch.cat(dist), torch.cat(idx)


def connect_components(x, colors, res: Resources | None = None) -> CooMatrix:
    """The cheapest edge out of each component (reference:
    raft::sparse::neighbors::connect_components): the squared-L2 1-NN of
    every point among points of other components, then per component the
    least (distance, point). Returns a CooMatrix of up to one edge a
    component, on the handle's device."""
    res = res or default_resources()
    x = res.put(x)
    colors = res.put(colors, _i32)
    n = x.shape[0]
    tile = _pw._choose_tile(n, n, 1, res.workspace_bytes)
    dist, idx = _cross_component_nn(x, colors, tile)
    # per-component argmin by rank: the (dist, point) order as unique ints
    order = torch.argsort(dist, stable=True)
    rank = torch.empty((n,), dtype=torch.int64, device=x.device)
    rank[order] = torch.arange(n, device=x.device)
    finite = torch.isfinite(dist)
    best = torch.full((n + 1,), _BIG, dtype=torch.int64, device=x.device)
    best.scatter_reduce_(0, colors.to(torch.int64), torch.where(finite, rank, _BIG), "amin")
    winner = finite & (rank == best[colors.to(torch.int64)])
    pts = torch.arange(n, dtype=_i32, device=x.device)
    rows = torch.where(winner, pts, n)
    cols = torch.where(winner, idx, n)
    vals = torch.where(winner, dist, torch.zeros_like(dist))
    corder = torch.argsort((~winner).to(torch.int8), stable=True)
    return CooMatrix(rows[corder], cols[corder], vals[corder], winner.sum().to(_i32), (n, n))


def knn(dataset: CsrMatrix, queries: CsrMatrix, k: int, metric="euclidean",
        metric_arg: float = 2.0, select_impl: str = "auto", res: Resources | None = None):
    """The k nearest dataset rows of each query row, both CSR (reference:
    raft::sparse::neighbors::brute_force_knn, sparse/neighbors/knn.cuh), on
    the matrices' device; unexpanded L2 is scored in its expanded form.
    ``select_impl`` is ``select_k_impl``'s: "auto"
    (the ``topk`` kernel for wide rows on a card), "torch" (the plain
    route) or "kernel". Returns (distances (m, k) float32, indices (m, k)
    int32)."""
    mt = _checked(queries, dataset, metric)
    mt = _EXPANDED_L2.get(mt, mt)
    expects(k <= dataset.shape[0], "k > dataset size")
    res = on_device_of(dataset, res)
    d = dataset.shape[1]
    m = queries.shape[0]
    qi, qv = csr_to_ell(queries)
    yd = dataset.todense().to(_f32)
    select_min = mt != DistanceType.InnerProduct
    tile = _tile_for(mt, m, dataset.shape[0], d, res)
    dists, ids = [], []
    for ti, tv in ell_tiles(qi, qv, tile, d):
        block = _dense_block(mt, float(metric_arg), _densify(ti, tv, d), yd)
        v, i = select_k_impl(block, None, int(k), select_min, impl=select_impl)
        dists.append(v)
        ids.append(i)
    return torch.cat(dists)[:m], torch.cat(ids)[:m]


def knn_graph(dataset: CsrMatrix, k: int, metric="euclidean",
              res: Resources | None = None) -> CooMatrix:
    """The kNN graph of a sparse point set as COO, self edges dropped
    (reference: raft::sparse::neighbors::knn_graph): a k + 1 search of the
    set against itself, then each row's first k edges to another point."""
    n = dataset.shape[0]
    expects(k + 1 <= n, "k + 1 > dataset size")
    dists, idx = knn(dataset, dataset, k + 1, metric=metric, res=res)
    dev = dists.device
    rows = torch.arange(n, dtype=_i32, device=dev)[:, None]
    # the self column is usually first, but ties may move it: drop it by id,
    # keeping the row's order (a stable partition)
    order = torch.argsort((idx == rows).to(torch.int8), dim=1, stable=True)[:, :k]
    cols = torch.gather(idx, 1, order).reshape(-1).to(_i32)
    vals = torch.gather(dists, 1, order).reshape(-1)
    return CooMatrix(rows.expand(n, k).reshape(-1).contiguous(), cols, vals,
                     torch.tensor(n * k, dtype=_i32, device=dev), (n, n))
