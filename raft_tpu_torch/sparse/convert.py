"""Sparse format conversions.

Counterpart of raft_tpu/sparse/convert.py (reference: raft/sparse/convert/
{coo,csr,dense}.cuh, detail/adj_to_csr.cuh). Capacities stay as they are;
sorting is two stable argsorts (column, then row) rather than one fused
``rows * n_cols + cols`` key, which overflows int32 at 100k x 100k.
"""

from __future__ import annotations

import torch

from .types import CooMatrix, CsrMatrix

__all__ = ["coo_to_csr", "csr_to_coo", "dense_to_csr", "dense_to_coo", "csr_to_dense",
           "coo_to_dense", "adj_to_csr", "sort_coo"]

_i32 = torch.int32


def sort_coo(coo: CooMatrix) -> CooMatrix:
    """Entries sorted by (row, col); padding (row == shape[0]) sorts last
    (reference: sparse/op/sort.cuh coo_sort)."""
    order = torch.argsort(coo.cols, stable=True)
    rows, cols, vals = coo.rows[order], coo.cols[order], coo.vals[order]
    order = torch.argsort(rows, stable=True)
    return CooMatrix(rows[order], cols[order], vals[order], coo.nnz, coo.shape)


def coo_to_csr(coo: CooMatrix, assume_sorted: bool = False) -> CsrMatrix:
    """COO -> CSR (reference: sparse/convert/csr.cuh sorted_coo_to_csr)."""
    if not assume_sorted:
        coo = sort_coo(coo)
    n_rows = coo.shape[0]
    valid = coo.valid_mask()
    # indptr[r] = valid entries with row < r; padding rows land in the
    # (n_rows + 1)-th count, which is dropped
    counts = torch.zeros((n_rows + 1,), dtype=torch.int64, device=coo.device)
    counts.index_add_(0, coo.rows.to(torch.int64), valid.to(torch.int64))
    indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts[:-1], 0)]).to(_i32)
    indptr[-1] = coo.nnz
    indices = torch.where(valid, coo.cols, coo.shape[1])
    data = torch.where(valid, coo.vals, torch.zeros_like(coo.vals))
    return CsrMatrix(indptr, indices, data, coo.shape)


def csr_to_coo(csr: CsrMatrix) -> CooMatrix:
    """CSR -> COO (reference: sparse/convert/coo.cuh csr_to_coo)."""
    return CooMatrix(csr.row_ids(), csr.indices, csr.data, csr.nnz, csr.shape)


def dense_to_coo(x: torch.Tensor, cap: int | None = None) -> CooMatrix:
    """Dense -> COO without the explicit zeros, in row-major order; ``cap``
    defaults to x.size. A cap below the nonzero count keeps the first
    ``cap`` entries (nnz clamped)."""
    n, m = x.shape
    cap = n * m if cap is None else int(cap)
    flat_x = x.reshape(-1)
    mask = flat_x != 0
    nnz = torch.clamp_max(mask.sum(), cap).to(_i32)
    # stable partition: nonzeros first, in row-major order
    order = torch.argsort((~mask).to(torch.int8), stable=True)[:cap]
    valid = mask[order]
    sel = order.to(torch.int64)
    rows = torch.where(valid, sel // m, n).to(_i32)
    cols = torch.where(valid, sel % m, m).to(_i32)
    vals = torch.where(valid, flat_x[order], torch.zeros((), dtype=x.dtype, device=x.device))
    return CooMatrix(rows, cols, vals, nnz, (n, m))


def dense_to_csr(x: torch.Tensor, cap: int | None = None) -> CsrMatrix:
    """Dense -> CSR (reference: sparse/convert/csr.cuh)."""
    return coo_to_csr(dense_to_coo(x, cap), assume_sorted=True)


def csr_to_dense(csr: CsrMatrix) -> torch.Tensor:
    return csr.todense()


def coo_to_dense(coo: CooMatrix) -> torch.Tensor:
    return coo.todense()


def adj_to_csr(adj: torch.Tensor) -> CsrMatrix:
    """Boolean adjacency -> CSR of unit weights (reference:
    sparse/convert/detail/adj_to_csr.cuh)."""
    return dense_to_csr(adj.to(torch.float32))
