"""raft_tpu_torch.parallel — distributed algorithm drivers over
raft_tpu_torch.comms.

Counterpart of raft_tpu/parallel. The reference ships the communicator and
leaves distributed algorithms to its consumers (cuML / cuGraph over
raft::comms, docs/source/using_comms.rst); here the canonical ones are in
the tree: sharded exact kNN with a global merge, multi-device k-means,
list-sharded IVF-Flat / IVF-PQ build and search, and per-shard CAGRA.

Every rank of a communicator calls a driver with the same global inputs and
gets the same global answer; each rank computes on its own block, on its
own device, through the single-device paths and their kernels.
"""

from . import cagra, ivf, kmeans, knn

__all__ = ["knn", "kmeans", "ivf", "cagra", "release_programs"]


def release_programs(comms=None) -> int:
    """Drop the drivers' memoized per-rank slices keyed on ``comms`` (every
    communicator when None): the mesh-teardown hook. The caches
    (``ivf._PROGRAMS``, ``cagra._PROGRAMS``) hold the
    Comms (and through it the mesh and its process groups) and the slices'
    device memory strongly, so a process that churns meshes must release
    retired ones. Returns how many entries were dropped."""
    caches = (ivf._PROGRAMS, cagra._PROGRAMS)
    if comms is None:
        n = sum(len(c) for c in caches)
        for c in caches:
            c.clear()
        return n
    return sum(c.release(comms) for c in caches)
