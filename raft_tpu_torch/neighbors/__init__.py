"""Nearest-neighbour search: exact brute force, IVF-PQ, exact refine and
CAGRA."""

from . import brute_force, cagra, ivf_pq, refine, sample_filter

__all__ = ["brute_force", "cagra", "ivf_pq", "refine", "sample_filter"]
