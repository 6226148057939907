"""Dense matrix utilities on tensors.

Counterpart of raft_tpu/matrix/ops.py (reference: raft::matrix, argmax.cuh,
argmin.cuh, gather.cuh, slice.cuh, copy.cuh, init.cuh, linewise_op.cuh,
col_wise_sort.cuh, reverse.cuh, sign_flip.cuh, triangular.cuh,
diagonal.cuh): the same 16 names, each one or two PyTorch calls. Inputs
may be tensors or arrays; results are tensors on the input's device.

:func:`segment_sum` is the port's own and stays out of ``__all__`` (the
JAX module's 16 names): the JAX package sums by label with
``jax.ops.segment_sum``, and every build path here sums through it.
"""

from __future__ import annotations

import torch

from ..core.errors import expects

__all__ = ["argmax", "argmin", "gather", "gather_if", "slice", "copy", "fill", "eye",
           "linewise_op", "col_wise_sort", "reverse", "sign_flip", "upper_triangular",
           "lower_triangular", "get_diagonal", "set_diagonal"]


def _t(m):
    return m if isinstance(m, torch.Tensor) else torch.as_tensor(m)


def argmax(m):
    """Row-wise argmax, first of equal maxima (reference: matrix/argmax.cuh)."""
    return torch.argmax(_t(m), dim=1).to(torch.int32)


def argmin(m):
    """Row-wise argmin, first of equal minima (reference: matrix/argmin.cuh)."""
    return torch.argmin(_t(m), dim=1).to(torch.int32)


def gather(m, row_ids):
    """Rows by index (reference: matrix/gather.cuh)."""
    m = _t(m)
    return m[_t(row_ids).to(device=m.device, dtype=torch.int64)]


def gather_if(m, row_ids, mask, fill_value=0):
    """Gathered rows where ``mask`` holds, else a row of ``fill_value``
    (reference: gatherIf)."""
    out = gather(m, row_ids)
    keep = _t(mask).to(device=out.device, dtype=torch.bool)[:, None]
    return torch.where(keep, out, torch.as_tensor(fill_value, dtype=out.dtype,
                                                  device=out.device))


def slice(m, row_start, row_end, col_start=0, col_end=None):  # noqa: A001 (ref name)
    """A submatrix (reference: matrix/slice.cuh)."""
    m = _t(m)
    col_end = m.shape[1] if col_end is None else col_end
    return m[row_start:row_end, col_start:col_end]


def copy(m):
    """A copy (reference: matrix/copy.cuh)."""
    return _t(m).clone()


def fill(shape, value, dtype=torch.float32, device=None):
    """A matrix of one value (reference: matrix/init.cuh)."""
    return torch.full(shape, value, dtype=dtype, device=device)


def eye(n, dtype=torch.float32, device=None):
    return torch.eye(n, dtype=dtype, device=device)


def linewise_op(m, vec, along_rows: bool, op):
    """``op(m, vec)`` with ``vec`` broadcast along rows (len n_cols) or
    columns (len n_rows) (reference: matrix/linewise_op.cuh)."""
    m = _t(m)
    vec = _t(vec).to(m.device)
    if along_rows:
        expects(vec.shape[0] == m.shape[1], "row-wise vector must have len n_cols")
        return op(m, vec[None, :])
    expects(vec.shape[0] == m.shape[0], "col-wise vector must have len n_rows")
    return op(m, vec[:, None])


def col_wise_sort(m, ascending: bool = True):
    """Each row's entries sorted (reference: matrix/col_wise_sort.cuh):
    (sorted, source_indices int32). A stable sort; descending reverses the
    ascending order (no negation, so unsigned and bool rows sort too)."""
    m = _t(m)
    order = torch.argsort(m, dim=1, stable=True)
    if not ascending:
        order = torch.flip(order, dims=[1])
    return torch.gather(m, 1, order), order.to(torch.int32)


def reverse(m, along_rows: bool = True):
    """Entries reversed within each row (``along_rows``: the column order
    swaps) or within each column (reference: matrix/reverse.cuh)."""
    return torch.flip(_t(m), dims=[1 if along_rows else 0])


def sign_flip(m):
    """Each column's sign flipped so its largest-magnitude entry is
    positive (reference: matrix/detail/math.cuh signFlip)."""
    m = _t(m)
    piv = torch.gather(m, 0, torch.argmax(m.abs(), dim=0)[None, :])
    return m * torch.where(piv < 0, -1.0, 1.0).to(m.dtype)


def upper_triangular(m):
    """Reference: matrix/triangular.cuh."""
    return torch.triu(_t(m))


def lower_triangular(m):
    return torch.tril(_t(m))


def get_diagonal(m):
    """Reference: matrix/diagonal.cuh."""
    return torch.diagonal(_t(m)).clone()


def set_diagonal(m, d):
    """A copy of ``m`` with its diagonal set to ``d``."""
    m = _t(m).clone()
    n = min(m.shape)
    i = torch.arange(n, device=m.device)
    m[i, i] = _t(d).to(device=m.device, dtype=m.dtype)[:n]
    return m


def segment_sum(vals, labels, n: int):
    """The rows of ``vals`` summed by label into ``n`` segments (empty ones
    0): what ``zeros(n, ...).index_add_(0, labels, vals)`` gives, in a fixed
    order. On a card ``index_add_`` sums through atomics in whatever order
    they land, and a build would differ from itself, so rows are sorted
    stably by label and each segment is summed in row order: the same bits
    every run. The CPU's ``index_add_`` already sums in row order, and is
    used there."""
    lab = labels.to(torch.int64)
    if vals.device.type == "cpu":
        return torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype).index_add_(
            0, lab, vals)
    lengths = torch.bincount(lab, minlength=n)
    return torch.segment_reduce(vals[torch.argsort(lab, stable=True)], "sum",
                                lengths=lengths, axis=0)
