"""The legacy ``spatial::knn`` surface: aliases into ``neighbors`` and
haversine kNN."""

from .knn import (approx_knn_build_index, approx_knn_search, brute_force_knn,
                  haversine_knn, knn, select_k)

__all__ = ["knn", "brute_force_knn", "haversine_knn", "select_k",
           "approx_knn_build_index", "approx_knn_search"]
