"""Structural sparse ops.

Counterpart of raft_tpu/sparse/op.py (reference: raft/sparse/op/{filter,
reduce,row_op,slice,sort}.cuh). Duplicates are reduced on *sorted* COO:
run starts come from comparing neighbouring (row, col) pairs, and each run
is summed (or maxed) over its contiguous entries with a 1-D
``torch.segment_reduce``: a fixed order (entry order on the CPU), so a
card gives the same bits every run.
"""

from __future__ import annotations

import torch

from .types import CooMatrix, counts

__all__ = ["sum_duplicates", "max_duplicates", "filter_entries", "remove_zeros",
           "slice_rows"]

_i32 = torch.int32


def _runs(coo: CooMatrix):
    """For sorted COO: (each entry's run id, run-start mask, valid mask)."""
    valid = coo.valid_mask()
    prev_r = torch.roll(coo.rows, 1)
    prev_c = torch.roll(coo.cols, 1)
    is_start = (coo.rows != prev_r) | (coo.cols != prev_c)
    if coo.cap:
        is_start[0] = True
    is_start = is_start & valid
    seg = torch.cumsum(is_start.to(torch.int64), 0) - 1
    return seg, is_start, valid


def _dedupe(coo: CooMatrix, combine: str) -> CooMatrix:
    seg, is_start, valid = _runs(coo)
    n_seg = is_start.sum().to(_i32)
    cap = coo.cap
    dev = coo.device
    # valid entries fill runs 0..n_seg-1 in order; padding (the tail) goes to
    # an extra run `cap`, dropped
    bucket = torch.where(valid, seg, cap)
    lengths = counts(bucket, cap + 1)
    if combine == "sum":
        vals = torch.segment_reduce(coo.vals, "sum", lengths=lengths, unsafe=True)[:cap]
    else:
        vals = torch.segment_reduce(coo.vals, "max", lengths=lengths, unsafe=True,
                                    initial=float("-inf"))[:cap]
        vals = torch.where(torch.arange(cap, device=dev) < n_seg, vals,
                           torch.zeros_like(vals))
    # each run's coordinates into its run's slot
    slot = torch.where(is_start, seg, cap)
    rows = torch.full((cap + 1,), coo.shape[0], dtype=_i32, device=dev)
    cols = torch.full((cap + 1,), coo.shape[1], dtype=_i32, device=dev)
    rows[slot] = coo.rows
    cols[slot] = coo.cols
    return CooMatrix(rows[:cap], cols[:cap], vals, n_seg, coo.shape)


def sum_duplicates(coo: CooMatrix) -> CooMatrix:
    """Duplicate (row, col) entries combined by sum. Input must be sorted."""
    return _dedupe(coo, "sum")


def max_duplicates(coo: CooMatrix) -> CooMatrix:
    """Duplicate (row, col) entries combined by max (reference:
    sparse/op/reduce.cuh max_duplicates). Input must be sorted."""
    return _dedupe(coo, "max")


def filter_entries(coo: CooMatrix, keep_mask: torch.Tensor) -> CooMatrix:
    """Entries where ``keep_mask`` holds, compacted to the front (reference:
    sparse/op/filter.cuh coo_remove_scalar)."""
    keep = keep_mask & coo.valid_mask()
    order = torch.argsort((~keep).to(torch.int8), stable=True)
    nnz = keep.sum().to(_i32)
    kept = keep[order]
    rows = torch.where(kept, coo.rows[order], coo.shape[0])
    cols = torch.where(kept, coo.cols[order], coo.shape[1])
    vals = torch.where(kept, coo.vals[order], torch.zeros_like(coo.vals))
    return CooMatrix(rows, cols, vals, nnz, coo.shape)


def remove_zeros(coo: CooMatrix) -> CooMatrix:
    """Explicit zeros dropped (reference: sparse/op/filter.cuh coo_remove_zeros)."""
    return filter_entries(coo, coo.vals != 0)


def slice_rows(coo: CooMatrix, start: int, stop: int) -> CooMatrix:
    """Rows [start, stop), re-indexed from 0 (reference: sparse/op/slice.cuh
    csr_row_slice_indptr)."""
    keep = (coo.rows >= start) & (coo.rows < stop)
    sliced = filter_entries(coo, keep)
    new_shape = (stop - start, coo.shape[1])
    rows = torch.where(sliced.valid_mask(), sliced.rows - start, new_shape[0]).to(_i32)
    return CooMatrix(rows, sliced.cols, sliced.vals, sliced.nnz, new_shape)
