"""Class-label utilities.

Counterpart of raft_tpu/label/classlabels.py (reference:
label/classlabels.cuh getUniquelabels :41, getOvrlabels :65,
make_monotonic :91). The same sort, adjacent-difference and prefix-sum
pipeline; the relabel is a left ``searchsorted`` into the sorted keys.
"""

from __future__ import annotations

import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources

__all__ = [
    "unique_labels",
    "unique_labels_padded",
    "get_ovr_labels",
    "make_monotonic",
]


def unique_labels(y, res: Resources | None = None):
    """Sorted unique labels on the handle's device (reference:
    getUniquelabels)."""
    return torch.unique((res or default_resources()).put(y), sorted=True)


def _is_new(s):
    return torch.cat([torch.ones(1, dtype=torch.bool, device=s.device), s[1:] != s[:-1]])


def unique_labels_padded(y, res: Resources | None = None):
    """(sorted uniques padded, n_unique): the output has ``y``'s length;
    the slots past ``n_unique`` (an int32 scalar tensor) hold the maximum
    label. Nothing is read back to the host."""
    s = torch.sort((res or default_resources()).put(y).reshape(-1)).values
    n = s.shape[0]
    is_new = _is_new(s)
    n_unique = is_new.sum(dtype=torch.int32)
    pos = torch.where(is_new, torch.cumsum(is_new, 0) - 1, n)      # n: dropped
    out = torch.empty(n + 1, dtype=s.dtype, device=s.device).scatter_(0, pos, s)[:n]
    return torch.where(torch.arange(n, device=s.device) < n_unique, out, s[-1]), n_unique


def get_ovr_labels(y, unique, idx: int, one=1, zero=0, res: Resources | None = None):
    """One-vs-rest binarization (reference: getOvrlabels): labels equal to
    ``unique[idx]`` become ``one``, the rest ``zero``, in ``y``'s type."""
    res = res or default_resources()
    y, unique = res.put(y), res.put(unique)
    expects(0 <= idx < unique.shape[0], "ovr index %d out of range [0, %d)", idx,
            unique.shape[0])
    return torch.where(y == unique[idx], one, zero).to(y.dtype)


def make_monotonic(y, filter_op=None, zero_based: bool = False, res: Resources | None = None):
    """Relabel to a contiguous monotonic set (reference: make_monotonic).

    Labels become ``1..n_classes`` (``0..n_classes-1`` when ``zero_based``)
    in the order of their values, int32. Elements for which
    ``filter_op(labels)`` (a callable on the tensor) is False keep their
    value; they sort last (as the type's maximum, or +inf for floats), so
    they shift no kept label.
    """
    y = (res or default_resources()).put(y)
    mask = (torch.ones(y.shape, dtype=torch.bool, device=y.device) if filter_op is None
            else filter_op(y).to(torch.bool))
    flat, keep = y.reshape(-1), mask.reshape(-1)
    big = torch.inf if y.dtype.is_floating_point else torch.iinfo(y.dtype).max
    keyed = torch.where(keep, flat, big)
    s = torch.sort(keyed).values
    dense = (torch.cumsum(_is_new(s), 0) - 1).to(torch.int32)
    out = dense[torch.searchsorted(s, keyed)] + (0 if zero_based else 1)
    return torch.where(keep, out, flat.to(torch.int32)).reshape(y.shape)
