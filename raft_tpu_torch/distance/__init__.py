"""Pairwise distances, fused and masked nearest neighbour, Gram matrices."""

from .fused_nn import fused_l2_nn, fused_l2_nn_argmin
from .kernels import KernelParams, KernelType, gram_matrix, kernel_factory
from .masked_nn import masked_l2_nn
from .pairwise import distance, pairwise_distance
from .types import DISTANCE_TYPES, SUPPORTED_DISTANCES, DistanceType, resolve_metric

__all__ = ["DistanceType", "DISTANCE_TYPES", "SUPPORTED_DISTANCES", "resolve_metric",
           "pairwise_distance", "distance", "fused_l2_nn", "fused_l2_nn_argmin",
           "masked_l2_nn", "KernelType", "KernelParams", "gram_matrix",
           "kernel_factory"]
