"""Combinatorial and iterative solvers: minimum spanning forest, Lanczos,
linear assignment (counterpart of raft_tpu/solver; reference:
raft/sparse/solver and raft/solver)."""

from .lanczos import compute_largest_eigenvectors, compute_smallest_eigenvectors, eigsh
from .lap import LapOutput, lap_solve
from .mst import MstOutput, mst

__all__ = ["LapOutput", "MstOutput", "compute_largest_eigenvectors",
           "compute_smallest_eigenvectors", "eigsh", "lap_solve", "mst"]
