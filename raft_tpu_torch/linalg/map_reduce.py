"""Elementwise maps, reductions, norms.

Counterpart of raft_tpu/linalg/map_reduce.py (reference: linalg/map.cuh,
map_reduce.cuh, unary_op.cuh .. ternary_op.cuh, add.cuh .. divide.cuh,
power.cuh, sqrt.cuh, reduce.cuh, norm.cuh, normalize.cuh,
reduce_rows_by_key.cuh, reduce_cols_by_key.cuh, mean_squared_error.cuh,
matrix_vector_op.cuh). User callables receive torch tensors on the
handle's device.

The by-key reductions are one-hot products in the JAX module. At the
k-means update's shape (1M rows, 1,024 keys) that one-hot is 4 GB, so here
rows are summed by key with ``matrix.ops.segment_sum``: a stable sort by
key and a segmented sum in row order, the same bits every run (no float
atomics). Keys outside ``[0, n_keys)`` add nothing, as a one-hot row of
zeros adds nothing.
"""

from __future__ import annotations

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..matrix.ops import segment_sum

__all__ = [
    "map",
    "map_reduce",
    "unary_op",
    "binary_op",
    "ternary_op",
    "eltwise_add",
    "eltwise_sub",
    "eltwise_multiply",
    "eltwise_divide",
    "power",
    "sqrt",
    "reduce",
    "norm",
    "normalize",
    "row_norm",
    "col_norm",
    "reduce_rows_by_key",
    "reduce_cols_by_key",
    "mean_squared_error",
    "matrix_vector_op",
    "NormType",
]

_f32 = torch.float32


def _res(res):
    return res or default_resources()


def map(fn, *arrays, res: Resources | None = None):  # noqa: A001 (reference name)
    """Elementwise map over aligned arrays (reference: linalg/map.cuh)."""
    res = _res(res)
    return fn(*[res.put(a) for a in arrays])


def map_reduce(fn, reduce_fn, *arrays, res: Resources | None = None):
    """Map, then a full reduction (reference: linalg/map_reduce.cuh; the
    neutral element is ``reduce_fn``'s own)."""
    res = _res(res)
    return reduce_fn(fn(*[res.put(a) for a in arrays]))


unary_op = map
binary_op = map
ternary_op = map


def eltwise_add(x, y, res: Resources | None = None):
    res = _res(res)
    return res.put(x) + res.put(y)


def eltwise_sub(x, y, res: Resources | None = None):
    res = _res(res)
    return res.put(x) - res.put(y)


def eltwise_multiply(x, y, res: Resources | None = None):
    res = _res(res)
    return res.put(x) * res.put(y)


def eltwise_divide(x, y, res: Resources | None = None):
    res = _res(res)
    return res.put(x) / res.put(y)


def power(x, p, res: Resources | None = None):
    return torch.pow(_res(res).put(x), p)


def sqrt(x, res: Resources | None = None):
    return torch.sqrt(_res(res).put(x))


def reduce(m, axis: int = 1, op=torch.sum, main_op=None, final_op=None,
           res: Resources | None = None):
    """Row (``axis=1``) or column (``axis=0``) reduction with pre and post
    maps (reference: linalg/reduce.cuh): ``main_op`` maps the elements,
    ``op`` reduces, ``final_op`` maps the result. ``op`` is called as
    ``op(m, dim=axis)`` (torch's convention, where the JAX module calls
    ``op(m, axis=axis)``); its default is ``torch.sum``."""
    m = _res(res).put(m)
    if main_op is not None:
        m = main_op(m)
    out = op(m, dim=axis)
    return final_op(out) if final_op is not None else out


class NormType:
    """Reference: linalg/norm_types.hpp (L1Norm / L2Norm / LinfNorm)."""

    L1 = "l1"
    L2 = "l2"
    Linf = "linf"


def norm(m, norm_type: str = NormType.L2, axis: int = 1, sqrt: bool = True,
         res: Resources | None = None):
    """Row or column norms, float32 (reference: linalg/norm.cuh). For L2,
    ``sqrt=False`` gives the squared norms."""
    m = _res(res).put(m, _f32)
    if norm_type == NormType.L1:
        return torch.abs(m).sum(dim=axis)
    if norm_type == NormType.Linf:
        return torch.abs(m).amax(dim=axis)
    expects(norm_type == NormType.L2, "unknown norm type %s", norm_type)
    sq = (m * m).sum(dim=axis)
    return torch.sqrt(sq) if sqrt else sq


def row_norm(m, norm_type=NormType.L2, sqrt=True, res: Resources | None = None):
    return norm(m, norm_type, axis=1, sqrt=sqrt, res=res)


def col_norm(m, norm_type=NormType.L2, sqrt=True, res: Resources | None = None):
    return norm(m, norm_type, axis=0, sqrt=sqrt, res=res)


def normalize(m, norm_type: str = NormType.L2, eps: float = 1e-10,
              res: Resources | None = None):
    """Each row divided by its norm, at least ``eps`` (reference:
    linalg/normalize.cuh)."""
    res = _res(res)
    m = res.put(m)
    n = norm(m, norm_type, axis=1, sqrt=True, res=res)
    return m / torch.clamp_min(n, eps)[:, None]


def _keyed(keys, n_keys: int):
    """Keys as int64, those outside [0, n_keys) sent to a spare segment."""
    keys = keys.to(torch.int64)
    return torch.where((keys >= 0) & (keys < n_keys), keys, n_keys)


def reduce_rows_by_key(m, keys, n_keys: int, weights=None, res: Resources | None = None):
    """Rows summed into per-key accumulators, (n_keys, d) float32
    (reference: linalg/reduce_rows_by_key.cuh, the k-means centroid
    update); ``weights`` scales each row first."""
    res = _res(res)
    m = res.put(m, _f32)
    if weights is not None:
        m = m * res.put(weights, _f32)[:, None]
    return segment_sum(m, _keyed(res.put(keys), n_keys), n_keys + 1)[:n_keys]


def reduce_cols_by_key(m, keys, n_keys: int, res: Resources | None = None):
    """Columns sharing a key summed, (n_rows, n_keys) float32 (reference:
    linalg/reduce_cols_by_key.cuh)."""
    res = _res(res)
    m = res.put(m, _f32)
    sums = segment_sum(m.T, _keyed(res.put(keys), n_keys), n_keys + 1)[:n_keys]
    return sums.T.contiguous()


def mean_squared_error(a, b, weight: float = 1.0, res: Resources | None = None):
    """Reference: linalg/mean_squared_error.cuh."""
    res = _res(res)
    return weight * torch.square(res.put(a, _f32) - res.put(b, _f32)).mean()


def matrix_vector_op(m, vec, op, along_rows: bool = True, res: Resources | None = None):
    """Broadcast a vector against the matrix's lines (reference:
    linalg/matrix_vector_op.cuh). ``along_rows=True`` applies vec[j] to
    column j of every row."""
    res = _res(res)
    m, vec = res.put(m), res.put(vec)
    if along_rows:
        expects(vec.shape[0] == m.shape[1], "vector must have len n_cols")
        return op(m, vec[None, :])
    expects(vec.shape[0] == m.shape[0], "vector must have len n_rows")
    return op(m, vec[:, None])
