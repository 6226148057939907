"""Nearest-neighbour search: exact brute force."""

from . import brute_force, sample_filter

__all__ = ["brute_force", "sample_filter"]
