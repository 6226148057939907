"""Nearest-neighbour search: exact brute force, IVF-Flat, IVF-PQ, CAGRA,
the random ball cover, exact refine, the epsilon neighbourhood and sample
filters."""

from . import ball_cover, brute_force, cagra, ivf_flat, ivf_pq, refine, sample_filter
from .brute_force import BruteForce, knn, knn_merge_parts
from .epsilon_neighborhood import eps_neighbors_l2sq
from .sample_filter import BitsetFilter, NoFilter

__all__ = ["ball_cover", "brute_force", "cagra", "ivf_flat", "ivf_pq", "refine",
           "sample_filter", "BruteForce", "knn", "knn_merge_parts", "eps_neighbors_l2sq",
           "BitsetFilter", "NoFilter"]
