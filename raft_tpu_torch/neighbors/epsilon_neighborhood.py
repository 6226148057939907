"""Epsilon neighbourhood: all pairs within a squared radius.

Counterpart of raft_tpu/neighbors/epsilon_neighborhood.py (reference:
neighbors/epsilon_neighborhood.cuh). Per row tile of ``x``: one
full-float32 product ``‖x‖² + ‖y‖² − 2·x·yᵀ``, the ``<= eps`` compare and the
row's count, so only the boolean adjacency is ever whole.
"""

from __future__ import annotations

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..distance.pairwise import _choose_tile, full_f32

__all__ = ["eps_neighbors_l2sq"]


def _eps_nn(x, y, eps_sq: float, tile: int):
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    yn = (yf * yf).sum(dim=1)
    adj, deg = [], []
    for i in range(0, xf.shape[0], tile):
        xb = xf[i:i + tile]
        with full_f32():
            d2 = ((xb * xb).sum(dim=1)[:, None] + yn[None, :]) - 2.0 * (xb @ yf.T)
        a = torch.clamp_min(d2, 0.0) <= eps_sq
        adj.append(a)
        deg.append(a.sum(dim=1, dtype=torch.int32))
    return torch.cat(adj), torch.cat(deg)


def eps_neighbors_l2sq(x, y=None, eps: float = 1.0, res: Resources | None = None):
    """Boolean adjacency of all (x_i, y_j) with ‖x_i − y_j‖² <= ``eps``, the
    squared radius (reference: epsilon_neighborhood.cuh:78-105). Returns
    (adj (m, n) bool, vertex_degree (m + 1,) int32) on the handle's device;
    the last degree entry is the total edge count."""
    res = res or default_resources()
    x = res.put(x)
    y = x if y is None else res.put(y)
    expects(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1], "bad x/y shapes")
    tile = _choose_tile(x.shape[0], y.shape[0], 1, res.workspace_bytes)
    # eps rounds to float32, as the JAX package's operand does
    eps32 = float(torch.tensor(eps, dtype=torch.float32))
    adj, deg = _eps_nn(x, y, eps32, tile)
    return adj, torch.cat([deg, deg.sum(dim=0, keepdim=True, dtype=torch.int32)])
