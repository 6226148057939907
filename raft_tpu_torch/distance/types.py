"""Distance metric vocabulary.

The port's own copy of raft_tpu/distance/types.py. Mirrors the reference
enum (cpp/include/raft/distance/distance_types.hpp:23-66, 20 metric values)
and the Python name mapping
(python/pylibraft/pylibraft/distance/pairwise_distance.pyx:62-88) so user code
written against pylibraft's metric strings works unchanged.
"""

from __future__ import annotations

import enum

__all__ = ["DistanceType", "DISTANCE_TYPES", "SUPPORTED_DISTANCES", "resolve_metric"]


class DistanceType(enum.IntEnum):
    """Reference: raft::distance::DistanceType (distance_types.hpp:23)."""

    L2Expanded = 0
    L2SqrtExpanded = 1
    CosineExpanded = 2
    L1 = 3
    L2Unexpanded = 4
    L2SqrtUnexpanded = 5
    InnerProduct = 6
    Linf = 7
    Canberra = 8
    LpUnexpanded = 9
    CorrelationExpanded = 10
    JaccardExpanded = 11
    HellingerExpanded = 12
    Haversine = 13
    BrayCurtis = 14
    JensenShannon = 15
    HammingUnexpanded = 16
    KLDivergence = 17
    RusselRaoExpanded = 18
    DiceExpanded = 19
    Precomputed = 100


# Name → enum map, identical strings to pylibraft (pairwise_distance.pyx:62-83).
DISTANCE_TYPES = {
    "l2": DistanceType.L2SqrtUnexpanded,
    "sqeuclidean": DistanceType.L2Unexpanded,
    "euclidean": DistanceType.L2SqrtUnexpanded,
    "l1": DistanceType.L1,
    "cityblock": DistanceType.L1,
    "inner_product": DistanceType.InnerProduct,
    "chebyshev": DistanceType.Linf,
    "canberra": DistanceType.Canberra,
    "cosine": DistanceType.CosineExpanded,
    "lp": DistanceType.LpUnexpanded,
    "correlation": DistanceType.CorrelationExpanded,
    "jaccard": DistanceType.JaccardExpanded,
    "hellinger": DistanceType.HellingerExpanded,
    "haversine": DistanceType.Haversine,
    "braycurtis": DistanceType.BrayCurtis,
    "jensenshannon": DistanceType.JensenShannon,
    "hamming": DistanceType.HammingUnexpanded,
    "kl_divergence": DistanceType.KLDivergence,
    "minkowski": DistanceType.LpUnexpanded,
    "russellrao": DistanceType.RusselRaoExpanded,
    "dice": DistanceType.DiceExpanded,
}

SUPPORTED_DISTANCES = sorted(DISTANCE_TYPES)


def resolve_metric(metric) -> DistanceType:
    """Accept a metric string or DistanceType (reference: DISTANCE_TYPES lookup)."""
    from ..core.errors import RaftError

    if isinstance(metric, DistanceType):
        return metric
    try:
        return DISTANCE_TYPES[str(metric).lower()]
    except KeyError:
        raise RaftError(
            f"metric {metric!r} is not supported; valid metrics: {SUPPORTED_DISTANCES}"
        ) from None
