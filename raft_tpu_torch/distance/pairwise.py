"""Pairwise distances: the GEMM-shaped metrics brute-force kNN uses.

Counterpart of raft_tpu/distance/pairwise.py (reference:
cpp/include/raft/distance/distance-inl.cuh:238). Expanded metrics are one
matrix product plus row norms and an elementwise epilogue; the product is a
plain ``torch.matmul`` outside any kernel, as the JAX package leaves it to
XLA. Unexpanded L2 is an elementwise accumulation over row tiles, sized by
the workspace budget.

``compute`` keeps the JAX package's two modes. "float32" is full float32:
every product here runs with ``torch.backends.cuda.matmul.allow_tf32`` off
(:func:`full_f32`), never in TF32. "bfloat16" rounds both operands to
bfloat16 and sums their exact products in float32, the JAX package's
single-pass mode.

Of the twenty metrics, this slice ports the ones brute force reaches:
L2 (expanded and unexpanded, squared or not), inner product and cosine.
The others raise ``RaftError("not yet ported")``.
"""

from __future__ import annotations

import contextlib

import torch

from ..core.errors import expects, fail
from ..core.resources import Resources, default_resources
from .types import DistanceType, resolve_metric

__all__ = ["pairwise_distance", "full_f32"]

_f32 = torch.float32

# operand type of the product for each compute mode (products and sums are
# float32 in both)
_PRECISIONS = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


@contextlib.contextmanager
def full_f32():
    """Run float32 matrix products in full float32 on CUDA: TF32 off for the
    body, the caller's setting restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _dot(x, y, prec=torch.float32):
    """x @ y.T in float32, operands rounded to ``prec`` first."""
    xo = x.to(prec).to(_f32)
    yo = y.to(prec).to(_f32)
    with full_f32():
        return xo @ yo.T


def _row_norms_sq(x):
    xf = x.to(_f32)
    return (xf * xf).sum(dim=1)


def _l2_expanded(x, y, sqrt: bool, prec=torch.float32):
    # xn + yn - 2·x·y, clamped at 0 before sqrt (ref: distance_ops/l2_exp.cuh)
    d2 = _row_norms_sq(x)[:, None] + _row_norms_sq(y)[None, :] - 2.0 * _dot(x, y, prec)
    d2 = torch.clamp_min(d2, 0.0)
    return torch.sqrt(d2) if sqrt else d2


def _cosine(x, y, prec=torch.float32):
    # 1 - x·y / (‖x‖‖y‖) (ref: distance_ops/cosine.cuh)
    xn = torch.sqrt(_row_norms_sq(x))
    yn = torch.sqrt(_row_norms_sq(y))
    return 1.0 - _dot(x, y, prec) / (xn[:, None] * yn[None, :])


def _inner_product(x, y, prec=torch.float32):
    # raw inner product, not 1 - ip
    return _dot(x, y, prec)


def _ew_l2(sqrt: bool):
    def f(xt, yt):
        d2 = torch.square(xt - yt).sum(dim=-1)
        return torch.sqrt(d2) if sqrt else d2

    return f


def _choose_tile(m: int, n: int, d: int, budget_bytes: int) -> int:
    """Memory-aware row tile size (reference: chooseTileSize,
    knn_brute_force.cuh:78). ``d`` is the broadcast depth: the feature dim
    for (tile, n, d) elementwise metrics, ~0 for GEMM-shaped paths that only
    materialize a (tile, n) score matrix."""
    per_row = max(n * (d + 2) * 4, 1)
    tile = max(min(budget_bytes // per_row, m), 8)
    return int(min(m, max(8, (tile // 8) * 8)))


def _pad_to_tiles(x, tile: int):
    """Pad rows with zeros up to a tile multiple and reshape to
    (num_tiles, tile, d)."""
    m, d = x.shape
    num = -(-m // tile)
    pad = num * tile - m
    if pad:
        x = torch.cat([x, x.new_zeros((pad, d))], dim=0)
    return x.reshape(num, tile, d), num


def _tiled_rows(x, y, fn, tile: int):
    """fn over row tiles of x, one (tile, n, d) broadcast at a time."""
    m = x.shape[0]
    yb = y.to(_f32)[None, :, :]
    return torch.cat([fn(x[i:i + tile].to(_f32)[:, None, :], yb)
                      for i in range(0, m, tile)], dim=0)


def _pairwise(x, y, metric: DistanceType, metric_arg: float, tile: int,
              compute: str = "float32"):
    prec = _PRECISIONS[compute]
    if metric == DistanceType.L2Expanded:
        return _l2_expanded(x, y, sqrt=False, prec=prec)
    if metric == DistanceType.L2SqrtExpanded:
        return _l2_expanded(x, y, sqrt=True, prec=prec)
    if metric == DistanceType.CosineExpanded:
        return _cosine(x, y, prec)
    if metric == DistanceType.InnerProduct:
        return _inner_product(x, y, prec)
    if metric == DistanceType.L2Unexpanded:
        return _tiled_rows(x, y, _ew_l2(False), tile)
    if metric == DistanceType.L2SqrtUnexpanded:
        return _tiled_rows(x, y, _ew_l2(True), tile)
    fail("metric %s is not yet ported to raft_tpu_torch", metric.name)


def pairwise_distance(x, y=None, metric="euclidean", metric_arg: float = 2.0,
                      compute: str = "float32", res: Resources | None = None):
    """All-pairs distances between the rows of ``x`` and ``y`` on the
    handle's device (reference: raft::distance::pairwise_distance;
    ``y=None`` means self-distance). Returns an (m, n) float32 tensor."""
    res = res or default_resources()
    mt = resolve_metric(metric)
    x = res.put(x)
    y = x if y is None else res.put(y)
    expects(x.ndim == 2 and y.ndim == 2, "inputs must be 2-D matrices")
    expects(x.shape[1] == y.shape[1], "feature dims must match: %d vs %d",
            x.shape[1], y.shape[1])
    expects(compute in _PRECISIONS,
            "compute must be 'float32' or 'bfloat16', got %r", compute)
    tile = _choose_tile(x.shape[0], y.shape[0], x.shape[1], res.workspace_bytes)
    return _pairwise(x, y, mt, float(metric_arg), tile, compute)
