"""Pairwise distances (the GEMM-shaped metrics brute force uses)."""

from .pairwise import pairwise_distance
from .types import DISTANCE_TYPES, SUPPORTED_DISTANCES, DistanceType, resolve_metric

__all__ = ["DistanceType", "DISTANCE_TYPES", "SUPPORTED_DISTANCES",
           "resolve_metric", "pairwise_distance"]
