"""Clustering: balanced k-means, the coarse quantizer of the IVF indexes."""

from . import kmeans_balanced

__all__ = ["kmeans_balanced"]
