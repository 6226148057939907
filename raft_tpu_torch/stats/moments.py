"""Summary statistics over dense matrices.

Counterpart of raft_tpu/stats/moments.py (reference: stats/mean.cuh,
stddev.cuh, meanvar.cuh, cov.cuh, sum.cuh, minmax.cuh, histogram.cuh,
weighted_mean.cuh, mean_center.cuh). The covariance product runs in full
float32. The histogram, a (n_bins, n_rows, n_cols) one-hot in the JAX
module, is a count here: one ``bincount`` of ``col·n_bins + bin``, exact
in any order.
"""

from __future__ import annotations

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources
from ..distance.pairwise import full_f32

__all__ = [
    "mean",
    "stddev",
    "vars_",
    "meanvar",
    "cov",
    "sum_",
    "minmax",
    "histogram",
    "weighted_mean",
    "mean_center",
    "mean_add",
]

_f32 = torch.float32


def _f(m, res):
    return (res or default_resources()).put(m, _f32)


def mean(m, axis: int = 0, sample: bool = False, res: Resources | None = None):
    """Column means (reference: stats/mean.cuh; ``sample`` divides by n - 1)."""
    m = _f(m, res)
    n = m.shape[axis]
    return m.sum(dim=axis) / (n - 1 if sample else n)


def vars_(m, mu=None, axis: int = 0, sample: bool = True, res: Resources | None = None):
    """Column variances about ``mu`` (default: the means) (reference:
    stats/vars.cuh)."""
    res = res or default_resources()
    m = _f(m, res)
    mu = m.mean(dim=axis) if mu is None else res.put(mu, _f32)
    n = m.shape[axis]
    return torch.square(m - mu.unsqueeze(axis)).sum(dim=axis) / (n - 1 if sample else n)


def stddev(m, mu=None, axis: int = 0, sample: bool = True, res: Resources | None = None):
    """Reference: stats/stddev.cuh."""
    return torch.sqrt(vars_(m, mu, axis, sample, res=res))


def meanvar(m, axis: int = 0, sample: bool = True, res: Resources | None = None):
    """Mean and variance (reference: stats/meanvar.cuh)."""
    res = res or default_resources()
    m = _f(m, res)
    mu = mean(m, axis, res=res)
    return mu, vars_(m, mu, axis, sample, res=res)


def cov(m, sample: bool = True, res: Resources | None = None):
    """Covariance of the columns (reference: stats/cov.cuh: a product of the
    centred data)."""
    m = _f(m, res)
    c = m - m.mean(dim=0, keepdim=True)
    n = m.shape[0]
    with full_f32():
        return (c.T @ c) / (n - 1 if sample else n)


def sum_(m, axis: int = 0, res: Resources | None = None):
    """Reference: stats/sum.cuh."""
    return _f(m, res).sum(dim=axis)


def minmax(m, axis: int = 0, res: Resources | None = None):
    """Per-column (min, max) (reference: stats/minmax.cuh)."""
    m = (res or default_resources()).put(m)
    return m.amin(dim=axis), m.amax(dim=axis)


def histogram(m, n_bins: int, lower: float, upper: float, res: Resources | None = None):
    """Per-column fixed-width histogram (reference: stats/histogram.cuh).

    Bin = floor((x - lower) / width) clipped to [0, n_bins). Returns
    (n_bins, n_cols) int32 counts.
    """
    m = _f(m, res)
    expects(upper > lower, "upper must exceed lower")
    # divide by a tensor: CUDA multiplies by the reciprocal of a scalar
    # divisor, which can move an element across a bin edge
    width = torch.tensor((upper - lower) / n_bins, dtype=_f32, device=m.device)
    idx = torch.clamp(torch.floor((m - lower) / width), 0, n_bins - 1).to(torch.int64)
    if m.ndim == 1:
        idx = idx[:, None]
    n_cols = idx.shape[1]
    flat = idx + torch.arange(n_cols, device=m.device, dtype=torch.int64)[None, :] * n_bins
    counts = torch.bincount(flat.reshape(-1), minlength=n_bins * n_cols)
    counts = counts.reshape(n_cols, n_bins).T.to(torch.int32).contiguous()
    return counts[:, 0] if m.ndim == 1 else counts


def weighted_mean(m, weights, axis: int = 0, res: Resources | None = None):
    """Weighted column means (reference: stats/weighted_mean.cuh)."""
    res = res or default_resources()
    m = _f(m, res)
    w = res.put(weights, _f32)
    w_exp = w.unsqueeze(1 - axis) if m.ndim == 2 else w
    return (m * w_exp).sum(dim=axis) / w.sum()


def mean_center(m, mu=None, axis: int = 0, res: Resources | None = None):
    """Means subtracted (reference: stats/mean_center.cuh)."""
    res = res or default_resources()
    m = _f(m, res)
    mu = m.mean(dim=axis) if mu is None else res.put(mu, _f32)
    return m - mu.unsqueeze(axis)


def mean_add(m, mu, axis: int = 0, res: Resources | None = None):
    """Means added back (reference: stats/mean_center.cuh meanAdd)."""
    res = res or default_resources()
    return _f(m, res) + res.put(mu).unsqueeze(axis)

