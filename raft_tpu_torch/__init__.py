"""raft_tpu_torch — the PyTorch / CUDA port of raft_tpu for NVIDIA Hopper.

A second package beside ``raft_tpu`` (the JAX reference, which it never
imports). It mirrors raft_tpu's paths and names so each counterpart sits at
the same place; inside it is plain PyTorch on an explicit ``torch.device``,
and every Pallas kernel of raft_tpu becomes a hand-written CUDA kernel for
``sm_90a`` beside a plain PyTorch version of the same function.

Entry points run on ``cuda`` unless the caller passes
``Resources(device="cpu")``; a CPU tensor takes each kernel's plain version.

Ported so far:
  core       errors, resource handle, index-file serialization (raft_tpu/13),
             logging, profiler ranges
  cluster    k-means, balanced k-means
  distance   metric vocabulary, pairwise distances (every metric), fused and
             masked L2 nearest neighbour, Gram matrices
  matrix     select_k (row-wise top-k; wide rows run the ``topk`` kernel)
  neighbors  brute-force kNN (the ``fused_knn`` kernel), IVF-Flat, IVF-PQ
             (the ``pq_scan`` kernel), CAGRA (the ``cagra_hop`` kernel),
             exact refine, the epsilon neighbourhood, sample filters
  obs        metrics, kernel-build attribution, the event journal, request
             traces, the memory ledger and its budget gate
  ops        the kernels and their build
  serve      micro-batched serving with warm hot-swap (SearchService,
             IndexRegistry, MicroBatcher, StagingBuffers)
  spatial    the legacy spatial::knn entry points
  stats      dispersion
"""

import importlib

from .core import RaftError, Resources, default_resources, set_default_resources
from .version import __version__

_SUBMODULES = {"cluster", "core", "distance", "matrix", "neighbors", "obs", "ops", "serve",
               "spatial", "stats"}


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'raft_tpu_torch' has no attribute {name!r}")
