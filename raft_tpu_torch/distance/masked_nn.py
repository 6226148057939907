"""Masked L2 nearest neighbour.

Counterpart of raft_tpu/distance/masked_nn.py (reference:
raft::distance::masked_l2_nn, distance/masked_nn.cuh). The rows of ``y`` are
partitioned into groups given by their exclusive end offsets, and
``adj[i, g]`` says whether row i of ``x`` may match group g. Per row tile of
``x``: one full-float32 product ``‖x‖² + ‖y‖² − 2·x·yᵀ``, the group mask as a
select, and an argmin whose ties go to the lowest column; only a (tile, n)
block is live at a time.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from .pairwise import _choose_tile, full_f32

__all__ = ["masked_l2_nn"]

_f32 = torch.float32


def _masked_nn(x, y, adj, group_ends, sqrt: bool, tile: int):
    n = y.shape[0]
    xf = x.to(_f32)
    yf = y.to(_f32)
    yn = (yf * yf).sum(dim=1)
    # column j belongs to group g(j) = searchsorted(group_ends, j, right)
    col_group = torch.searchsorted(group_ends, torch.arange(n, device=y.device),
                                   right=True)
    vals, idxs = [], []
    for i in range(0, xf.shape[0], tile):
        xb = xf[i:i + tile]
        with full_f32():
            d2 = ((xb * xb).sum(dim=1)[:, None] + yn[None, :]) - 2.0 * (xb @ yf.T)
        d2 = torch.clamp_min(d2, 0.0)
        if sqrt:
            d2 = torch.sqrt(d2)
        col_mask = adj[i:i + tile][:, col_group]
        masked = torch.where(col_mask, d2, math.inf)
        val, idx = torch.min(masked, dim=1)
        any_valid = col_mask.any(dim=1)
        vals.append(torch.where(any_valid, val, math.inf))
        idxs.append(torch.where(any_valid, idx, -1).to(torch.int32))
    return torch.cat(vals), torch.cat(idxs)


def masked_l2_nn(x, y, adj, group_idxs, sqrt: bool = False,
                 res: Resources | None = None):
    """Masked L2 1-nearest neighbour of each row of ``x`` over the groups of
    ``y`` it may match (reference: masked_nn.cuh:109-150).

    ``x`` (m, d), ``y`` (n, d); ``adj`` (m, num_groups) boolean;
    ``group_idxs`` (num_groups,) the exclusive end offset of each group in
    ``y``, strictly increasing, the last equal to n. Returns (distances (m,)
    float32, squared unless ``sqrt``; indices (m,) int32) on the handle's
    device; a row with no admissible group reads +inf and -1.
    """
    res = res or default_resources()
    x = res.put(x)
    y = res.put(y)
    adj = res.put(adj, torch.bool)
    group_host = np.asarray(group_idxs, np.int64)
    expects(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1], "bad x/y shapes")
    expects(tuple(adj.shape) == (x.shape[0], group_host.shape[0]),
            "adj must be (m, num_groups)")
    expects(group_host.size > 0 and int(group_host[-1]) == y.shape[0]
            and bool(np.all(np.diff(group_host) > 0)) and int(group_host[0]) > 0,
            "group_idxs must be strictly increasing exclusive ends with last == n")
    tile = _choose_tile(x.shape[0], y.shape[0], 1, res.workspace_bytes)
    return _masked_nn(x, y, adj, res.put(group_host), bool(sqrt), tile)
