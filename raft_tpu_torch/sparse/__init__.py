"""Sparse containers, conversions, linear algebra, structural ops, distances
and neighbours (counterpart of raft_tpu/sparse; reference: raft/sparse)."""

from .convert import (adj_to_csr, coo_to_csr, coo_to_dense, csr_to_coo, csr_to_dense,
                      dense_to_coo, dense_to_csr, sort_coo)
from .distance import SPARSE_SUPPORTED, csr_to_ell, pairwise_distance
from .linalg import (add, degree, laplacian, normalize_rows, row_norm, spmm, spmv,
                     symmetrize, transpose)
from .neighbors import connect_components, knn, knn_graph
from .op import filter_entries, max_duplicates, remove_zeros, slice_rows, sum_duplicates
from .types import CooMatrix, CsrMatrix, from_scipy, make_coo, make_csr

__all__ = [
    "CooMatrix",
    "CsrMatrix",
    "make_coo",
    "make_csr",
    "from_scipy",
    "coo_to_csr",
    "csr_to_coo",
    "dense_to_csr",
    "dense_to_coo",
    "csr_to_dense",
    "coo_to_dense",
    "adj_to_csr",
    "sort_coo",
    "spmv",
    "spmm",
    "add",
    "degree",
    "row_norm",
    "normalize_rows",
    "transpose",
    "symmetrize",
    "laplacian",
    "sum_duplicates",
    "max_duplicates",
    "filter_entries",
    "remove_zeros",
    "slice_rows",
    "pairwise_distance",
    "csr_to_ell",
    "SPARSE_SUPPORTED",
    "knn",
    "knn_graph",
    "connect_components",
]
