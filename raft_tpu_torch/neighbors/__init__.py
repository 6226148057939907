"""Nearest-neighbour search: exact brute force, IVF-PQ and exact refine."""

from . import brute_force, ivf_pq, refine, sample_filter

__all__ = ["brute_force", "ivf_pq", "refine", "sample_filter"]
