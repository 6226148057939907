"""Candidate sample filters (counterpart of
raft_tpu/neighbors/sample_filter.py; reference: raft::neighbors::filtering,
sample_filter_types.hpp). A filter is a boolean keep-mask over dataset rows;
filtered-out rows can never win a top-k."""

from __future__ import annotations

import numpy as np
import torch

from ..core.errors import expects

__all__ = ["NoFilter", "BitsetFilter", "resolve_filter", "validate_filter_covers",
           "apply_id_filter"]


def _as_bool_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.bool)
    return torch.from_numpy(np.asarray(x, dtype=bool))


class NoFilter:
    """Keep everything (ref: none_ivf_sample_filter)."""

    mask = None


class BitsetFilter:
    """Keep dataset row ``i`` iff ``bitset[i]`` (ref: bitset_filter).
    ``words`` (optional) is the same mask already packed as
    ``ops.pq_scan.pack_keep_words`` packs it, on the mask's device: IVF-PQ's
    ``pq_scan_topk`` route reads it instead of packing the mask per search
    (a stream index packs its tombstone bitset once per write)."""

    def __init__(self, bitset, words=None):
        self.mask = _as_bool_tensor(bitset)
        self.words = words


def resolve_filter(f, device=None):
    """Normalize a filter argument to a bool keep-mask tensor on ``device``,
    or None."""
    if f is None or isinstance(f, NoFilter):
        return None
    mask = f.mask if isinstance(f, BitsetFilter) else _as_bool_tensor(f)
    return mask if device is None else mask.to(device)


def validate_filter_covers(index, keep_mask) -> None:
    """Check that the keep-mask covers every stored id: the largest of an
    IVF index's ``list_ids`` (its ``max_stored_id``, read when the index was
    made), or ``size - 1`` for an index whose ids are its dataset rows
    (cagra)."""
    max_id = getattr(index, "max_stored_id", None)
    if max_id is None:
        max_id = index.size - 1
    expects(keep_mask.shape[0] > max_id,
            "sample filter length %d must cover max stored id %d",
            keep_mask.shape[0], max_id)


def apply_id_filter(scores, ids, keep_mask, select_min: bool):
    """``scores`` where the candidate's id is kept, else +inf (``select_min``)
    or -inf: the mask epilogue of the IVF scans. ``ids`` may hold -1
    padding, which stays invalid."""
    bad = float("inf") if select_min else float("-inf")
    valid = ids >= 0
    kept = keep_mask[torch.clamp_min(ids, 0).to(torch.int64)] & valid
    return torch.where(kept, scores, bad)
