"""Sparse linear algebra.

Counterpart of raft_tpu/sparse/linalg.py (reference: raft/sparse/linalg/
{spmm,add,degree,norm,symmetrize,transpose}.cuh). SpMV / SpMM gather the
rows of the dense operand and sum each CSR row's contiguous run of entries
with ``torch.segment_reduce`` (the rows' lengths, plus one run for the
padding, dropped; a column at a time): a fixed order, so a card gives the
same bits every run, where ``index_add_`` would sum through atomics.
Degree and norm sums run the same way.
"""

from __future__ import annotations

import torch

from ..core.errors import expects, fail
from .convert import coo_to_csr, csr_to_coo, sort_coo
from .op import max_duplicates, sum_duplicates
from .types import CooMatrix, CsrMatrix, counts

__all__ = ["spmv", "spmm", "add", "degree", "row_norm", "normalize_rows", "transpose",
           "symmetrize", "laplacian"]

_i32 = torch.int32


def _row_runs(a: CsrMatrix):
    """Lengths of each row's run of entries, then the padding's."""
    deg = (a.indptr[1:] - a.indptr[:-1]).to(torch.int64)
    pad = (a.cap - a.indptr[-1:]).to(torch.int64)
    return torch.cat([deg, pad])


def row_reduce(a: CsrMatrix, contrib, reduce: str = "sum", initial=None):
    """Each row's entries of ``contrib`` ((cap,) or (cap, c), aligned with
    a's entries) reduced in a fixed order: (n_rows,) or (n_rows, c). A
    (cap, c) block goes column by column: on a card the 1-D
    ``segment_reduce`` (a segmented reduction of fixed shape, the same bits
    every run) is tens of times faster than the 2-D one (``chip_smoke.py``
    phase c times both). On the CPU either sums each run in entry order."""
    runs = _row_runs(a)

    def one(col):
        return torch.segment_reduce(col, reduce, lengths=runs, unsafe=True,
                                    initial=initial)[:a.shape[0]]

    if contrib.ndim == 1:
        return one(contrib)
    return torch.stack([one(contrib[:, j]) for j in range(contrib.shape[1])], dim=1)


def _gather_rows(a: CsrMatrix, b):
    """b's rows (or entries) at a's column indices, padding clamped."""
    return b[torch.clamp_max(a.indices, b.shape[0] - 1).to(torch.int64)]


def spmv(a: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """CSR @ vector (reference: sparse/linalg/spmm.cuh with 1 column)."""
    return row_reduce(a, a.data * _gather_rows(a, x))


def spmm(a: CsrMatrix, b: torch.Tensor) -> torch.Tensor:
    """CSR @ dense (reference: raft/sparse/linalg/spmm.cuh, cusparse SpMM):
    out[r, :] = sum of data[e] * b[indices[e], :] over row r's entries e,
    in a fixed order (entry order on the CPU)."""
    return row_reduce(a, a.data[:, None] * _gather_rows(a, b))


def add(a: CsrMatrix, b: CsrMatrix) -> CsrMatrix:
    """C = A + B, duplicates merged (reference: sparse/linalg/add.cuh)."""
    expects(a.shape == b.shape, "shapes must match: %s vs %s", a.shape, b.shape)
    ac, bc = csr_to_coo(a), csr_to_coo(b)
    merged = CooMatrix(torch.cat([ac.rows, bc.rows]), torch.cat([ac.cols, bc.cols]),
                       torch.cat([ac.vals, bc.vals]), ac.nnz + bc.nnz, a.shape)
    return coo_to_csr(sum_duplicates(sort_coo(merged)), assume_sorted=True)


def degree(a) -> torch.Tensor:
    """Entries a row (reference: sparse/linalg/degree.cuh coo_degree)."""
    if isinstance(a, CsrMatrix):
        return (a.indptr[1:] - a.indptr[:-1]).to(_i32)
    idx = torch.where(a.valid_mask(), a.rows, a.shape[0]).to(torch.int64)
    return counts(idx, a.shape[0] + 1)[:-1].to(_i32)


def row_norm(a: CsrMatrix, norm: str = "l2") -> torch.Tensor:
    """Each row's L1 / squared L2 / Linf norm (reference: sparse/linalg/
    norm.cuh)."""
    if norm == "l1":
        return row_reduce(a, torch.abs(a.data))
    if norm == "l2":
        return row_reduce(a, a.data * a.data)
    if norm == "linf":
        return row_reduce(a, torch.abs(a.data), "max", initial=0.0)
    fail("unknown norm %r", norm)


def normalize_rows(a: CsrMatrix, norm: str = "l1") -> CsrMatrix:
    """Each row scaled to unit norm (reference: sparse/linalg/norm.cuh
    csr_row_normalize_l1 / csr_row_normalize_max)."""
    norms = row_norm(a, norm)
    if norm == "l2":
        norms = torch.sqrt(norms)
    scale = torch.where(norms > 0, 1.0 / torch.clamp_min(norms, 1e-30),
                        torch.zeros_like(norms))
    rows = torch.clamp_max(a.row_ids(), a.shape[0] - 1).to(torch.int64)
    return CsrMatrix(a.indptr, a.indices, a.data * scale[rows], a.shape)


def transpose(a: CsrMatrix) -> CsrMatrix:
    """Aᵀ (reference: sparse/linalg/transpose.cuh, cusparse csr2csc)."""
    coo = csr_to_coo(a)
    valid = coo.valid_mask()
    t = CooMatrix(torch.where(valid, coo.cols, a.shape[1]),
                  torch.where(valid, coo.rows, a.shape[0]),
                  coo.vals, coo.nnz, (a.shape[1], a.shape[0]))
    return coo_to_csr(t)


def symmetrize(a: CsrMatrix, mode: str = "sum") -> CsrMatrix:
    """A + Aᵀ (``mode="sum"``) or max(A, Aᵀ) (``"max"``, the kNN graph's)
    (reference: sparse/linalg/symmetrize.cuh)."""
    ac = csr_to_coo(a)
    valid = ac.valid_mask()
    rows = torch.cat([ac.rows, torch.where(valid, ac.cols, a.shape[0])])
    cols = torch.cat([ac.cols, torch.where(valid, ac.rows, a.shape[1])])
    merged = sort_coo(CooMatrix(rows, cols, torch.cat([ac.vals, ac.vals]), ac.nnz * 2,
                                a.shape))
    reducer = sum_duplicates if mode == "sum" else max_duplicates
    return coo_to_csr(reducer(merged), assume_sorted=True)


def laplacian(a: CsrMatrix, normalized: bool = False) -> CsrMatrix:
    """The graph Laplacian L = D - A (or I - D^-1/2 A D^-1/2) as CSR
    (reference: spectral/matrix_wrappers.hpp laplacian_matrix_t)."""
    coo = csr_to_coo(a)
    n = a.shape[0]
    d = row_reduce(a, coo.vals)
    if normalized:
        dinv = torch.where(d > 0, 1.0 / torch.sqrt(d), torch.zeros_like(d))
        r = torch.clamp_max(coo.rows, n - 1).to(torch.int64)
        c = torch.clamp_max(coo.cols, a.shape[1] - 1).to(torch.int64)
        off_vals = -coo.vals * dinv[r] * dinv[c]
        diag_vals = torch.ones((n,), dtype=a.data.dtype, device=a.device)
    else:
        off_vals = -coo.vals
        diag_vals = d
    ar = torch.arange(n, dtype=_i32, device=a.device)
    vals = torch.cat([torch.where(coo.valid_mask(), off_vals, torch.zeros_like(off_vals)),
                      diag_vals])
    merged = sort_coo(CooMatrix(torch.cat([coo.rows, ar]), torch.cat([coo.cols, ar]), vals,
                                coo.nnz + n, (n, n)))
    return coo_to_csr(sum_duplicates(merged), assume_sorted=True)
