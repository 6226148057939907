"""Clustering: k-means and balanced k-means (the IVF indexes' coarse
quantizer)."""

from . import kmeans, kmeans_balanced
from .kmeans import KMeansOutput, KMeansParams
from .kmeans_balanced import KMeansBalancedParams

__all__ = ["kmeans", "kmeans_balanced", "KMeansParams", "KMeansOutput",
           "KMeansBalancedParams"]
