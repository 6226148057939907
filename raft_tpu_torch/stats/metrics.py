"""Evaluation metrics.

Counterpart of raft_tpu/stats/metrics.py; this slice holds only
:func:`dispersion` (reference: stats/dispersion.cuh), which
``cluster.kmeans.find_k`` needs.
"""

from __future__ import annotations

import torch

from ..core.resources import Resources, default_resources

__all__ = ["dispersion"]


def dispersion(centroids, cluster_sizes, global_centroid=None,
               res: Resources | None = None):
    """Size-weighted scatter of centroids around the global mean,
    sqrt(Σ_c size_c · ‖c − g‖²); ``g`` defaults to the size-weighted mean of
    the centroids. Returns a float32 scalar tensor on the handle's device."""
    res = res or default_resources()
    c = res.put(centroids, torch.float32)
    sizes = res.put(cluster_sizes, torch.float32)
    if global_centroid is None:
        g = (c * sizes[:, None]).sum(dim=0) / sizes.sum()
    else:
        g = res.put(global_centroid, torch.float32)
    sq = torch.square(c - g[None, :]).sum(dim=1)
    return torch.sqrt((sizes * sq).sum())
