"""Candidate sample filters (counterpart of
raft_tpu/neighbors/sample_filter.py; reference: raft::neighbors::filtering,
sample_filter_types.hpp). A filter is a boolean keep-mask over dataset rows;
filtered-out rows can never win a top-k."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["NoFilter", "BitsetFilter", "resolve_filter"]


def _as_bool_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.bool)
    return torch.from_numpy(np.asarray(x, dtype=bool))


class NoFilter:
    """Keep everything (ref: none_ivf_sample_filter)."""

    mask = None


class BitsetFilter:
    """Keep dataset row ``i`` iff ``bitset[i]`` (ref: bitset_filter)."""

    def __init__(self, bitset):
        self.mask = _as_bool_tensor(bitset)


def resolve_filter(f, device=None):
    """Normalize a filter argument to a bool keep-mask tensor on ``device``,
    or None."""
    if f is None or isinstance(f, NoFilter):
        return None
    mask = f.mask if isinstance(f, BitsetFilter) else _as_bool_tensor(f)
    return mask if device is None else mask.to(device)
