"""The legacy ``spatial::knn`` entry points.

Counterpart of raft_tpu/spatial/knn.py (reference: spatial/knn/knn.cuh,
detail/ann_quantized.cuh, detail/haversine_distance.cuh): aliases of the
``neighbors`` surface, the approximate-kNN dispatch over IVF-Flat and IVF-PQ,
and haversine kNN.
"""

from __future__ import annotations

import dataclasses

from ..core.resources import Resources
from ..matrix.select_k import select_k  # noqa: F401  (spatial/knn/knn.cuh alias)
from ..neighbors.brute_force import knn as brute_force_knn

__all__ = ["knn", "brute_force_knn", "haversine_knn", "select_k",
           "approx_knn_build_index", "approx_knn_search"]

# spatial::knn::knn was the original name of brute_force::knn
knn = brute_force_knn


def approx_knn_build_index(params, dataset, metric="sqeuclidean",
                           res: Resources | None = None):
    """Build an IVF-Flat or IVF-PQ index from its ``IndexParams``, with
    ``metric`` in place of the params' (reference: ann_quantized.cuh:42)."""
    from ..neighbors import ivf_flat, ivf_pq

    if isinstance(params, ivf_flat.IndexParams):
        return ivf_flat.build(dataclasses.replace(params, metric=metric), dataset, res=res)
    if isinstance(params, ivf_pq.IndexParams):
        return ivf_pq.build(dataclasses.replace(params, metric=metric), dataset, res=res)
    raise TypeError(f"unsupported legacy ANN params: {type(params)!r}")


def approx_knn_search(index, queries, k: int, n_probes: int = 20,
                      res: Resources | None = None):
    """Search an IVF-Flat or IVF-PQ index with ``n_probes`` (reference:
    ann_quantized.cuh:96)."""
    from ..neighbors import ivf_flat, ivf_pq

    if isinstance(index, ivf_flat.IvfFlatIndex):
        return ivf_flat.search(ivf_flat.SearchParams(n_probes=n_probes), index, queries,
                               k, res=res)
    if isinstance(index, ivf_pq.IvfPqIndex):
        return ivf_pq.search(ivf_pq.SearchParams(n_probes=n_probes), index, queries, k,
                             res=res)
    raise TypeError(f"unsupported legacy ANN index: {type(index)!r}")


def haversine_knn(dataset, queries, k: int, res: Resources | None = None):
    """k nearest neighbours under the great-circle metric; rows are (latitude,
    longitude) in radians (reference: detail/haversine_distance.cuh)."""
    return brute_force_knn(dataset, queries, k, metric="haversine", res=res)
