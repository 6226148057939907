"""Spectral partitioning and modularity clustering (counterpart of
raft_tpu/spectral; reference: raft/spectral)."""

from .partition import (ClusterSolverConfig, EigenSolverConfig, SpectralOutput,
                        analyze_modularity, analyze_partition, modularity_maximization,
                        partition)

__all__ = ["ClusterSolverConfig", "EigenSolverConfig", "SpectralOutput",
           "analyze_modularity", "analyze_partition", "modularity_maximization",
           "partition"]
