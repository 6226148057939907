"""Clustering: k-means, balanced k-means (the IVF indexes' coarse
quantizer) and single-linkage agglomerative clustering."""

from . import kmeans, kmeans_balanced
from .kmeans import KMeansOutput, KMeansParams
from .kmeans_balanced import KMeansBalancedParams
from .single_linkage import SingleLinkageOutput, single_linkage

__all__ = ["kmeans", "kmeans_balanced", "single_linkage", "KMeansParams", "KMeansOutput",
           "KMeansBalancedParams", "SingleLinkageOutput"]
