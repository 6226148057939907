"""Fused L2 nearest neighbour: for each row, the distance to and index of its
nearest row of another set.

Counterpart of raft_tpu/distance/fused_nn.py (reference:
distance/fused_l2_nn-inl.cuh). :func:`_fused_l2_nn` is the k-means
assignment step: per row tile, one full-float32 product
``|y|² - 2·x·yᵀ`` and its argmin, so only a (tile, n) block is ever live.
The product stays a plain ``torch.matmul`` (the JAX package leaves it to
XLA). :func:`fused_l2_nn` takes the ``fused_knn`` kernel at k=1 where the
JAX package takes its fused Pallas kernel: large candidate sets, under the
same :func:`~raft_tpu_torch.ops.fused_knn.shapes_eligible` gate.
"""

from __future__ import annotations

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from .pairwise import _choose_tile, full_f32

__all__ = ["fused_l2_nn", "fused_l2_nn_argmin"]


def _fused_l2_nn(x, y, sqrt: bool, tile: int):
    """(min distances (m,) float32, argmin (m,) int32) of each row of ``x``
    over the rows of ``y``; ties go to the lowest row, as ``jnp.argmin``'s
    (and ``torch.argmin``'s) do."""
    xf = x.to(torch.float32)
    yf = y.to(torch.float32)
    yn2 = (yf * yf).sum(dim=1)
    vals, idxs = [], []
    for i in range(0, xf.shape[0], tile):
        with full_f32():
            scores = yn2[None, :] - 2.0 * (xf[i:i + tile] @ yf.T)
        v, ix = torch.min(scores, dim=1)
        vals.append(v)
        idxs.append(ix.to(torch.int32))
    vals = torch.clamp_min(torch.cat(vals) + (xf * xf).sum(dim=1), 0.0)
    if sqrt:
        vals = torch.sqrt(vals)
    return vals, torch.cat(idxs)


def fused_l2_nn(x, y, sqrt: bool = False, res: Resources | None = None):
    """For each row of ``x``, the L2 distance and index of its nearest row of
    ``y`` (reference: raft::distance::fused_l2_nn). Returns (distances (m,)
    float32, squared unless ``sqrt``; indices (m,) int32), on the handle's
    device."""
    from ..ops.fused_knn import fused_knn, shapes_eligible

    res = res or default_resources()
    x = res.put(x)
    y = res.put(y)
    expects(x.ndim == 2 and y.ndim == 2, "inputs must be 2-D matrices")
    expects(x.shape[1] == y.shape[1], "feature dims must match")
    if shapes_eligible(y.shape[0], y.shape[1], 1):
        dist, idx = fused_knn(y.to(torch.float32), x.to(torch.float32), 1,
                              metric="l2", sqrt=sqrt)
        return dist[:, 0], idx[:, 0]
    tile = _choose_tile(x.shape[0], y.shape[0], 1, res.workspace_bytes)
    return _fused_l2_nn(x, y, sqrt, tile)


def fused_l2_nn_argmin(x, y, sqrt: bool = False, res: Resources | None = None):
    """Argmin-only variant (the pylibraft surface)."""
    return fused_l2_nn(x, y, sqrt=sqrt, res=res)[1]
