"""Pairwise distances: the GEMM-shaped metrics brute-force kNN uses.

Counterpart of raft_tpu/distance/pairwise.py (reference:
cpp/include/raft/distance/distance-inl.cuh:238). Expanded metrics are one
matrix product plus row norms and an elementwise epilogue; the product is a
plain ``torch.matmul`` outside any kernel, as the JAX package leaves it to
XLA. The unexpanded metrics (L1, Linf, Canberra, Lp,
Bray-Curtis, Jensen-Shannon, Hamming, Haversine and unexpanded L2) are an
elementwise accumulation over row tiles of ``x``, one (tile, n, d)
broadcast at a time, the tile sized by the workspace budget
(:func:`_choose_tile`).

``compute`` keeps the JAX package's two modes. "float32" is full float32:
every product here runs with ``torch.backends.cuda.matmul.allow_tf32`` off
(:func:`full_f32`), never in TF32. "bfloat16" rounds both operands to
bfloat16 and sums their exact products in float32, the JAX package's
single-pass mode.

All nineteen metrics of the JAX package are here, with its zero-guards:
``where(x > 0, log(where(x > 0, x, 1)), 0)`` for the logarithms of KL and
Jensen-Shannon, ``0/0 -> 0`` in Canberra, Bray-Curtis, Jaccard and Dice,
and ``clip(h, 0, 1)`` in Haversine. ``Precomputed`` has no formula and
raises.
"""

from __future__ import annotations

import contextlib

import torch

from ..config import auto_convert_output
from ..core.errors import expects, fail
from ..core.resources import Resources, default_resources
from ..obs.instrument import dtype_of, instrument, nrows
from .types import DistanceType, resolve_metric

__all__ = ["pairwise_distance", "distance", "full_f32"]

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


def _correlation(x, y, prec=torch.float32):
    # 1 - Pearson r: the cosine of row-centred vectors
    # (ref: distance_ops/correlation.cuh)
    xc = x.to(_f32) - x.to(_f32).mean(dim=1, keepdim=True)
    yc = y.to(_f32) - y.to(_f32).mean(dim=1, keepdim=True)
    return _cosine(xc, yc, prec)


def _inner_product(x, y, prec=torch.float32):
    # raw inner product, not 1 - ip
    return _dot(x, y, prec)


def _hellinger(x, y, prec=torch.float32):
    # sqrt(max(0, 1 - Σ√(xᵢyᵢ))) (ref: distance_ops/hellinger.cuh)
    acc = _dot(torch.sqrt(x.to(_f32)), torch.sqrt(y.to(_f32)), prec)
    return torch.sqrt(torch.clamp_min(1.0 - acc, 0.0))


def _russelrao(x, y, prec=torch.float32):
    # (k - x·y) / k, k = n_features (ref: distance_ops/russel_rao.cuh)
    k = x.shape[1]
    return (k - _dot(x, y, prec)) / k


def _guarded_log(v):
    """log v where v > 0, else 0 (the JAX package's zero-guard)."""
    pos = v > 0
    return torch.where(pos, torch.log(torch.where(pos, v, 1.0)), 0.0)


def _kl_divergence(x, y, prec=torch.float32):
    # 0.5·Σ x(log x - log y); terms with x == 0 vanish, log y reads 0 where
    # y == 0 (ref: distance_ops/kl_divergence.cuh)
    xf = x.to(_f32)
    xlogx = torch.where(xf > 0, xf * _guarded_log(xf), 0.0).sum(dim=1)
    return 0.5 * (xlogx[:, None] - _dot(x, _guarded_log(y.to(_f32)), prec))


def _set_sums(x, y, prec):
    """|x ∧ y| (the product) and the row sums of x and y."""
    return _dot(x, y, prec), x.to(_f32).sum(dim=1), y.to(_f32).sum(dim=1)


def _jaccard(x, y, prec=torch.float32):
    # binary-set semantics: 1 - |x∧y| / |x∨y|, 0/0 -> 0
    inter, sx, sy = _set_sums(x, y, prec)
    union = sx[:, None] + sy[None, :] - inter
    pos = union > 0
    return torch.where(pos, 1.0 - inter / torch.where(pos, union, 1.0), 0.0)


def _dice(x, y, prec=torch.float32):
    # binary-set semantics: 1 - 2|x∧y| / (|x| + |y|), 0/0 -> 0
    inter, sx, sy = _set_sums(x, y, prec)
    tot = sx[:, None] + sy[None, :]
    pos = tot > 0
    return torch.where(pos, 1.0 - 2.0 * inter / torch.where(pos, tot, 1.0), 0.0)


# Unexpanded (elementwise-accumulation) metrics: f(xt, yt) with
# xt: (t, 1, d), yt: (1, n, d) -> (t, n).


def _ew_l1(xt, yt):
    return torch.abs(xt - yt).sum(dim=-1)


def _ew_l2(sqrt: bool):
    def f(xt, yt):
        d2 = torch.square(xt - yt).sum(dim=-1)
        return torch.sqrt(d2) if sqrt else d2

    return f


def _ew_linf(xt, yt):
    return torch.abs(xt - yt).amax(dim=-1)


def _ew_canberra(xt, yt):
    # Σ|x-y| / (|x|+|y|), 0/0 -> 0 (ref: distance_ops/canberra.cuh)
    num = torch.abs(xt - yt)
    den = torch.abs(xt) + torch.abs(yt)
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, 1.0), 0.0).sum(dim=-1)


def _ew_lp(p: float):
    # (Σ|x-y|^p)^(1/p) (ref: distance_ops/lp_unexp.cuh)
    def f(xt, yt):
        return torch.pow(torch.pow(torch.abs(xt - yt), p).sum(dim=-1), 1.0 / p)

    return f


def _ew_braycurtis(xt, yt):
    # Σ|x-y| / Σ|x+y|, 0/0 -> 0
    den = torch.abs(xt + yt).sum(dim=-1)
    num = torch.abs(xt - yt).sum(dim=-1)
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)


def _ew_jensenshannon(xt, yt):
    # sqrt(0.5·Σ[x log(x/m) + y log(y/m)]), m = (x+y)/2, zero-guarded
    # (ref: distance_ops/jensen_shannon.cuh)
    logm = _guarded_log(0.5 * (xt + yt))
    acc = (-xt * (logm - _guarded_log(xt)) - yt * (logm - _guarded_log(yt))).sum(dim=-1)
    return torch.sqrt(torch.clamp_min(0.5 * acc, 0.0))


def _ew_hamming(xt, yt):
    # mean(xᵢ ≠ yᵢ) (ref: distance_ops/hamming.cuh)
    return (xt != yt).to(_f32).mean(dim=-1)


def _ew_haversine(xt, yt):
    # 2·asin√(sin²(Δφ/2) + cos φ₁ cos φ₂ sin²(Δλ/2)) on (lat, lon) radians,
    # d == 2 (ref: spatial/knn/detail/haversine_distance.cuh)
    lat1, lon1 = xt[..., 0], xt[..., 1]
    lat2, lon2 = yt[..., 0], yt[..., 1]
    s1 = torch.sin(0.5 * (lat2 - lat1))
    s2 = torch.sin(0.5 * (lon2 - lon1))
    h = s1 * s1 + torch.cos(lat1) * torch.cos(lat2) * s2 * s2
    return 2.0 * torch.asin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))


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


_EXPANDED = {
    DistanceType.CosineExpanded: _cosine,
    DistanceType.CorrelationExpanded: _correlation,
    DistanceType.InnerProduct: _inner_product,
    DistanceType.HellingerExpanded: _hellinger,
    DistanceType.RusselRaoExpanded: _russelrao,
    DistanceType.KLDivergence: _kl_divergence,
    DistanceType.JaccardExpanded: _jaccard,
    DistanceType.DiceExpanded: _dice,
}


def _pairwise(x, y, metric: DistanceType, metric_arg: float, tile: int,
              compute: str = "float32"):
    prec = _PRECISIONS[compute]
    if metric == DistanceType.L2Expanded:
        return _l2_expanded(x, y, sqrt=False, prec=prec)
    if metric == DistanceType.L2SqrtExpanded:
        return _l2_expanded(x, y, sqrt=True, prec=prec)
    if metric in _EXPANDED:
        return _EXPANDED[metric](x, y, prec)
    ew = {
        DistanceType.L1: _ew_l1,
        DistanceType.L2Unexpanded: _ew_l2(False),
        DistanceType.L2SqrtUnexpanded: _ew_l2(True),
        DistanceType.Linf: _ew_linf,
        DistanceType.Canberra: _ew_canberra,
        DistanceType.LpUnexpanded: _ew_lp(metric_arg),
        DistanceType.BrayCurtis: _ew_braycurtis,
        DistanceType.JensenShannon: _ew_jensenshannon,
        DistanceType.HammingUnexpanded: _ew_hamming,
        DistanceType.Haversine: _ew_haversine,
    }.get(metric)
    if ew is None:
        fail("metric %s has no pairwise formula", metric.name)
    return _tiled_rows(x, y, ew, tile)


@auto_convert_output
@instrument(
    "distance.pairwise_distance",
    items=lambda a, kw: nrows(a[0] if a else kw["x"]),
    labels=lambda a, kw: {
        "metric": str(a[2] if len(a) > 2 else kw.get("metric", "euclidean")),
        "dtype": dtype_of(a[0] if a else kw["x"]),
    },
)
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
    if mt == DistanceType.Haversine:
        expects(x.shape[1] == 2, "haversine requires (lat, lon) inputs with d == 2")
    expects(compute in _PRECISIONS,
            "compute must be 'float32' or 'bfloat16', got %r", compute)
    tile = _choose_tile(x.shape[0], y.shape[0], x.shape[1], res.workspace_bytes)
    return _pairwise(x, y, mt, float(metric_arg), tile, compute)


# pylibraft names the same call ``distance`` (pairwise_distance.pyx:93)
distance = pairwise_distance
