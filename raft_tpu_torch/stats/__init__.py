"""Statistics: so far only ``dispersion``, which ``kmeans.find_k`` uses."""

from .metrics import dispersion

__all__ = ["dispersion"]
