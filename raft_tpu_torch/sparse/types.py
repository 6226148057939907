"""Sparse containers: padded COO / CSR matrices on tensors.

Counterpart of raft_tpu/sparse/types.py (reference: core/device_coo_matrix.hpp,
core/device_csr_matrix.hpp, sparse/coo.hpp, sparse/csr.hpp). The layout is
the JAX package's: a capacity ``cap`` with a valid count ``nnz`` (a 0-d
tensor, so no structural op has to read it back), and padding that every op
can drop by position:

  * COO: padding entries have ``rows == shape[0]`` and ``cols ==
    shape[1]``; their vals are 0.
  * CSR: ``indptr[-1] == nnz``; entries at positions >= nnz are padding
    with ``indices == shape[1]`` and ``data == 0``.

Where the JAX package scatters with ``mode="drop"``, the port scatters into
a buffer one slot (or one row and column) longer and slices the extra off.
Sums of entries that land on one position run in a fixed order
(:func:`scatter_sum_dense`): entry order on the CPU, and on a card an order
of its own that gives the same bits every run.

:func:`make_coo` / :func:`make_csr` take numpy arrays or tensors and a
``res=``; given a JAX matrix's padded fields (``make_coo(..., nnz=)``) they
rebuild the same matrix, and ``to_numpy()`` hands the fields back, so one
matrix can be given to both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core.errors import expects
from ..core.resources import Resources, default_resources

__all__ = ["CooMatrix", "CsrMatrix", "make_coo", "make_csr"]

_i32 = torch.int32


def counts(idx, size: int):
    """How many entries of ``idx`` (int64, each in [0, size)) name each
    slot: ``bincount`` without its host read of the maximum on a card."""
    out = torch.zeros((size,), dtype=torch.int64, device=idx.device)
    return out.index_add_(0, idx, torch.ones_like(idx))


def _sum_runs(vals, keys):
    """Entries of equal ``keys`` (int64) summed in a fixed order: returns
    (sorted keys, run-start mask, each entry's run sum). No host read."""
    order = torch.argsort(keys, stable=True)
    sk, sv = keys[order], vals[order]
    start = torch.ones_like(sk, dtype=torch.bool)
    start[1:] = sk[1:] != sk[:-1]
    seg = torch.cumsum(start.to(torch.int64), 0) - 1
    sums = torch.segment_reduce(sv, "sum", lengths=counts(seg, sk.shape[0]), axis=0,
                                unsafe=True)
    return sk, start, sums[seg]


def scatter_sum_dense(rows, cols, vals, shape):
    """A dense ``shape`` matrix with ``vals`` summed at (rows, cols); entries
    with ``rows == shape[0]`` or ``cols == shape[1]`` are dropped. Duplicates
    sum in a fixed order (a stable sort and one segment sum): on the CPU in
    entry order, the order of the JAX package's ``.at[rows, cols].add(vals,
    mode="drop")``; on a card the same bits every run, where ``index_put_``
    sums through atomics."""
    n, m = shape
    out = torch.zeros(((n + 1) * (m + 1) + 1,), dtype=vals.dtype, device=vals.device)
    if vals.numel():
        keys = rows.to(torch.int64) * (m + 1) + cols.to(torch.int64)
        sk, start, sums = _sum_runs(vals, keys)
        out[torch.where(start, sk, out.shape[0] - 1)] = sums
    return out[:-1].reshape(n + 1, m + 1)[:n, :m]


def _positions(cap: int, device):
    return torch.arange(cap, dtype=_i32, device=device)


@dataclasses.dataclass(frozen=True)
class CooMatrix:
    """Padded COO matrix (reference: raft/core/device_coo_matrix.hpp).

    rows / cols: int32 (cap,), vals: float (cap,), nnz: int32 0-d tensor;
    entries past ``nnz`` are padding with ``rows == shape[0]``.
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    nnz: torch.Tensor
    shape: Tuple[int, int]

    @property
    def cap(self) -> int:
        return self.rows.shape[0]

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def valid_mask(self) -> torch.Tensor:
        return _positions(self.cap, self.device) < self.nnz

    def todense(self) -> torch.Tensor:
        return scatter_sum_dense(self.rows, self.cols, self.vals, self.shape)

    def to_numpy(self) -> dict:
        """The fields as numpy, padding kept: ``make_coo(**m.to_numpy())``
        (or the JAX package's ``CooMatrix``) rebuilds the matrix."""
        return dict(rows=self.rows.cpu().numpy(), cols=self.cols.cpu().numpy(),
                    vals=self.vals.cpu().numpy(), nnz=int(self.nnz), shape=self.shape)

    def to(self, device) -> "CooMatrix":
        return CooMatrix(self.rows.to(device), self.cols.to(device), self.vals.to(device),
                         self.nnz.to(device), self.shape)


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """Padded CSR matrix (reference: raft/core/device_csr_matrix.hpp).

    indptr: int32 (n_rows + 1,) with ``indptr[-1] == nnz``, indices: int32
    (cap,), data: float (cap,); entries past ``nnz`` are padding with
    ``indices == shape[1]``.
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    shape: Tuple[int, int]

    @property
    def cap(self) -> int:
        return self.indices.shape[0]

    @property
    def nnz(self) -> torch.Tensor:
        return self.indptr[-1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def valid_mask(self) -> torch.Tensor:
        return _positions(self.cap, self.device) < self.nnz

    def row_ids(self) -> torch.Tensor:
        """Each entry's row (padding entries get shape[0])."""
        pos = _positions(self.cap, self.device)
        rows = torch.searchsorted(self.indptr[1:], pos, right=True).to(_i32)
        return torch.where(self.valid_mask(), rows, self.shape[0])

    def todense(self) -> torch.Tensor:
        return scatter_sum_dense(self.row_ids(), self.indices, self.data, self.shape)

    def to_numpy(self) -> dict:
        """The fields as numpy, padding kept: ``make_csr(**m.to_numpy())``
        (or the JAX package's ``CsrMatrix``) rebuilds the matrix."""
        return dict(indptr=self.indptr.cpu().numpy(), indices=self.indices.cpu().numpy(),
                    data=self.data.cpu().numpy(), shape=self.shape)

    def to(self, device) -> "CsrMatrix":
        return CsrMatrix(self.indptr.to(device), self.indices.to(device),
                         self.data.to(device), self.shape)


def _shape(shape):
    return int(shape[0]), int(shape[1])


def _float_vals(v, res):
    # float64 and integer values are held as float32, as the JAX package
    # holds them (x64 off)
    t = res.put(v)
    return t if t.dtype in (torch.float32, torch.float16, torch.bfloat16) else t.to(torch.float32)


def make_coo(rows, cols, vals, shape, cap: int | None = None, nnz: int | None = None,
             res: Resources | None = None) -> CooMatrix:
    """A padded CooMatrix on the handle's device from exact-length triplets,
    padded to ``cap``. With ``nnz``, the arrays are a padded matrix's fields
    (``to_numpy()``, or the JAX package's ``CooMatrix``) and are kept as they
    are."""
    res = res or default_resources()
    shape = _shape(shape)
    rows, cols = res.put(rows, _i32), res.put(cols, _i32)
    vals = _float_vals(vals, res)
    size = int(rows.shape[0])
    if nnz is not None:
        expects(0 <= nnz <= size and (cap is None or cap == size),
                "nnz %d / cap %r do not fit padded fields of %d entries", nnz, cap, size)
        return CooMatrix(rows, cols, vals, torch.tensor(int(nnz), dtype=_i32,
                                                        device=rows.device), shape)
    cap = size if cap is None else int(cap)
    expects(cap >= size, "cap %d < nnz %d", cap, size)
    pad = cap - size
    dev = rows.device
    rows = torch.cat([rows, torch.full((pad,), shape[0], dtype=_i32, device=dev)])
    cols = torch.cat([cols, torch.full((pad,), shape[1], dtype=_i32, device=dev)])
    vals = torch.cat([vals, torch.zeros((pad,), dtype=vals.dtype, device=dev)])
    return CooMatrix(rows, cols, vals, torch.tensor(size, dtype=_i32, device=dev), shape)


def make_csr(indptr, indices, data, shape, cap: int | None = None,
             res: Resources | None = None) -> CsrMatrix:
    """A padded CsrMatrix on the handle's device from exact-length CSR
    arrays, padded to ``cap``. A padded matrix's fields (``to_numpy()``, or
    the JAX package's ``CsrMatrix``) already carry ``indptr[-1] == nnz`` and
    their padding, and come back as the same matrix."""
    res = res or default_resources()
    shape = _shape(shape)
    indptr, indices = res.put(indptr, _i32), res.put(indices, _i32)
    data = _float_vals(data, res)
    size = int(indices.shape[0])
    expects(indptr.shape[0] == shape[0] + 1, "indptr must have n_rows + 1 = %d entries, got %d",
            shape[0] + 1, indptr.shape[0])
    cap = size if cap is None else int(cap)
    expects(cap >= size, "cap %d < nnz %d", cap, size)
    pad = cap - size
    dev = indices.device
    indices = torch.cat([indices, torch.full((pad,), shape[1], dtype=_i32, device=dev)])
    data = torch.cat([data, torch.zeros((pad,), dtype=data.dtype, device=dev)])
    return CsrMatrix(indptr, indices, data, shape)


def from_scipy(sp, cap: int | None = None, res: Resources | None = None):
    """A CooMatrix (from scipy's COO) or CsrMatrix (any other format) on
    the handle's device."""
    if sp.format == "coo":
        return make_coo(sp.row, sp.col, sp.data, sp.shape, cap, res=res)
    csr = sp.tocsr()
    return make_csr(np.asarray(csr.indptr), np.asarray(csr.indices), np.asarray(csr.data),
                    csr.shape, cap, res=res)
