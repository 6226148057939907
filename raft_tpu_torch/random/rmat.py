"""R-MAT rectangular graph generator.

Counterpart of raft_tpu/random/rmat.py (reference:
random/rmat_rectangular_generator.cuh). Every edge's source and destination
bits are chosen level by level from the quadrant probabilities
theta = (a, b, c, d), from one (n_edges, max_scale) uniform draw. Given the
draw, the bits are the JAX module's arithmetic (:func:`_rmat_bits`), so the
two packages agree exactly on the same draw.
"""

from __future__ import annotations

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from .rng import _draw

__all__ = ["rmat_rectangular_gen", "rmat"]


def _rmat_bits(u, theta, r_scale: int, c_scale: int):
    """Edges from the uniform draw ``u`` (n_edges, L) and the per-level
    quadrant probabilities ``theta`` (L, 4), rows summing to 1: level l's
    quadrant is the number of thresholds a, a+b, a+b+c that u[:, l] reaches;
    its high bit is a source bit, its low bit a destination bit, each
    weighted by 2^(scale - 1 - l) while l < that side's scale."""
    cum = torch.cumsum(theta, dim=1)
    src = torch.zeros(u.shape[0], dtype=torch.int64, device=u.device)
    dst = torch.zeros_like(src)
    for lv in range(u.shape[1]):
        col = u[:, lv]
        q = (col >= cum[lv, 0]).long() + (col >= cum[lv, 1]).long() + (col >= cum[lv, 2]).long()
        if lv < r_scale:
            src += ((q >> 1) & 1) << (r_scale - 1 - lv)
        if lv < c_scale:
            dst += (q & 1) << (c_scale - 1 - lv)
    return src.to(torch.int32), dst.to(torch.int32)


def rmat_rectangular_gen(rng, theta, r_scale: int, c_scale: int, n_edges: int,
                         res: Resources | None = None):
    """Generate R-MAT edges.

    ``theta``: (4,) quadrant probabilities (a, b, c, d) used at every level,
    or (max_scale, 4) per-level probabilities. Returns ``(src (n_edges,),
    dst (n_edges,))`` int32 with src < 2**r_scale, dst < 2**c_scale.
    """
    res = res or default_resources()
    theta = res.put(theta, torch.float32)
    max_scale = max(r_scale, c_scale)
    expects(0 < max_scale <= 31, "scales must be in [1, 31] for int32 vertex ids")
    if theta.ndim == 1:
        expects(theta.shape[0] == 4, "flat theta must have 4 entries")
        theta = theta[None, :].repeat(max_scale, 1)
    expects(tuple(theta.shape) == (max_scale, 4), "theta must be (max_scale, 4)")
    theta = theta / theta.sum(dim=1, keepdim=True)
    g, dev = _draw(rng, res)
    u = torch.rand((n_edges, max_scale), generator=g, device=dev)
    return _rmat_bits(u, theta, int(r_scale), int(c_scale))


# pylibraft's short name
rmat = rmat_rectangular_gen
